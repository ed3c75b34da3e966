import os
import pathlib

# Smoke tests must see the single real CPU device (the dry-run sets its own
# 512-device flag in a separate process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # hypothesis is a dev extra (requirements-dev.txt). Without it, skip the
    # property-test modules instead of dying at collection time — tier-1 must
    # still run every non-hypothesis test. Match actual import statements,
    # not a bare substring (a docstring mentioning hypothesis must not
    # silently drop a module from collection).
    import re
    _IMPORT = re.compile(r"^\s*(from|import)\s+hypothesis\b", re.MULTILINE)
    collect_ignore = sorted(
        p.name for p in pathlib.Path(__file__).parent.glob("test_*.py")
        if _IMPORT.search(p.read_text()))
else:
    settings.register_profile("ci", deadline=None, max_examples=25,
                              derandomize=True)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with the CUDA toolkit (nvcc); "
        "skips on a CPU-only host")
