"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled on first use by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``kernels/build/``
(listed in ``.gitignore``), then loaded with ``ctypes``. The library name
carries a hash of the source and flags, so an edited source is rebuilt and
never shadowed by a stale library. Nothing here runs at import time.

``build_all`` starts one ``nvcc`` per source at once, so a fresh checkout
pays for the slowest source and not for the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Any, Dict, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``CUDA_HOME``, else the
    toolkit's standard install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = pathlib.Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, tmp: pathlib.Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start compiling ``name`` unless its library exists. Returns
    ``(process, tmp, out)`` or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent builder sees all or none


def build_all(names: Sequence[str]) -> None:
    """Compile every named source that has no library yet, all at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


# ---- calling a kernel --------------------------------------------------------
_fns: Dict[tuple, Any] = {}

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def function(name: str, symbol: str, argtypes: Sequence) -> Any:
    """``symbol`` of ``csrc/<name>.cu`` with its ``argtypes`` declared
    (``c_void_p`` for every pointer and the stream, so ctypes never cuts a
    64-bit address to an int); it returns a ``cudaError_t`` code."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(str(dtype))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return code


def check(err: int, name: str) -> None:
    """Raise on a refused launch (the C entry point returns
    ``cudaGetLastError()``; a refused launch never runs and no later
    synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
