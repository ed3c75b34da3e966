"""The port's engine (solo path: cache miss and prefix-cache hit) against the
JAX package's, plus the port's package rules.

The engines run the reduced qwen1.5-0.5b, granite-3-8b, llama3.1-8b,
internvl2-2b (vlm), musicgen-large (audio), mixtral-8x22b and
llama4-scout-17b-a16e (moe) configs, and phi3-mini-3.8b reduced to its
head_dim of 96 (4 MHA heads, an untied head) (the ``setup`` fixture's params;
granite and llama have 4 query heads per kv head, internvl2 2, musicgen
none shared, and no qkv bias; the last five an untied LM head) on bridged
weights, in bfloat16, the MoE configs in float32 (a bf16 route flip may
move a whole row; ``tests/test_torch_moe.py`` holds the MoE layer in
bf16); scores are held to the repo's 2e-2 engine gate (the same gate
``tests/test_engine.py`` holds hit scores to against a cold engine). MoE
capacity is priced per forward call, so a hit, which routes only its
suffix, may drop other assignments than a cold run (ROADMAP §C17, a
behaviour of the reference): at the MoE configs the hit-vs-cold gap is held
to the reference engines' gap on the same requests, not to 0.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_config as j_reduce_config
from repro.core import engine as jengine
from repro.core import jct as jjct
from repro.core import kv_policy as jkv
from repro.core import prefix_cache as jpc
from repro.models.model import build
from repro.runtime.sharding import materialize
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import jct as tjct
from repro_torch.core import kv_policy as tkv
from repro_torch.core import prefix_cache as tpc
from repro_torch.core.engine import EngineConfig, PrefillOnlyEngine
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.runtime.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCORE_GATE = 2e-2
YES, NO = 5, 9
ARCHS = ("qwen1.5-0.5b", "granite-3-8b", "llama3.1-8b", "internvl2-2b",
         "musicgen-large", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "phi3-mini-3.8b")
# widths a reduced config keeps from its published one: phi3's head_dim 96
WIDTHS = {"phi3-mini-3.8b": dict(head_dim=96)}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    dt = "float32" if get_config(request.param).is_moe else "bfloat16"
    over = dict(hybrid_chunk=0, dtype=dt, param_dtype=dt,
                **WIDTHS.get(request.param, {}))
    jcfg = j_reduce_config(j_get_config(request.param), **over)
    tcfg = reduce_config(get_config(request.param), **over)
    jparams = materialize(jax.random.PRNGKey(0), build(jcfg).defs(),
                          jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _serve(eng, requests):
    out = []
    for toks in requests:
        rid = eng.submit(toks, allowed_tokens=(YES, NO))
        assert eng.step() == rid
        out.append(eng.results[rid])
    return out


def test_engine_matches_reference_miss_then_hit(setup):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(0)
    profile = rng.integers(0, tcfg.vocab_size, 150).tolist()
    trace = [profile + rng.integers(0, tcfg.vocab_size, n).tolist()
             for n in (20, 30, 12)]
    ecfg = dict(max_pack_requests=1, cache_capacity_tokens=2048)
    want = _serve(jengine.PrefillOnlyEngine(
        jcfg, jparams, jengine.EngineConfig(**ecfg)), trace)
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(**ecfg),
                            device="cpu")
    got = _serve(eng, trace)
    assert [g["n_cached"] for g in got] == [w["n_cached"] for w in want]
    assert got[0]["n_cached"] == 0 and all(g["n_cached"] > 0
                                           for g in got[1:])
    for g, w in zip(got, want):
        assert g["n_input"] == w["n_input"]
        for t in (YES, NO):
            assert abs(g["scores"][t] - w["scores"][t]) < SCORE_GATE
    assert eng.stats()["hit_rate"] > 0
    assert eng.forwards == len(trace)


def test_hit_scores_match_cold_engine(setup):
    """A hit scores as a cold engine does; at an MoE config, the hit-vs-cold
    gap equals the reference engines' on the same requests (§C17)."""
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    profile = rng.integers(0, tcfg.vocab_size, 80).tolist()
    post = rng.integers(0, tcfg.vocab_size, 20).tolist()
    reqs = [profile + [3] * 20, profile + post]
    warm = PrefillOnlyEngine(tcfg, tparams,
                             EngineConfig(cache_capacity_tokens=2048),
                             device="cpu")
    hit = _serve(warm, reqs)[1]
    assert hit["n_cached"] > 0
    cold = PrefillOnlyEngine(tcfg, tparams,
                             EngineConfig(cache_capacity_tokens=0),
                             device="cpu")
    ref = _serve(cold, [profile + post])[0]
    assert ref["n_cached"] == 0
    want_gap = dict.fromkeys((YES, NO), 0.0)
    if tcfg.is_moe:
        jhit = _serve(jengine.PrefillOnlyEngine(
            jcfg, jparams, jengine.EngineConfig(cache_capacity_tokens=2048)),
            reqs)[1]
        jcold = _serve(jengine.PrefillOnlyEngine(
            jcfg, jparams, jengine.EngineConfig(cache_capacity_tokens=0)),
            reqs[1:])[0]
        assert jhit["n_cached"] == hit["n_cached"]
        want_gap = {t: jhit["scores"][t] - jcold["scores"][t]
                    for t in (YES, NO)}
    for t in (YES, NO):
        gap = hit["scores"][t] - ref["scores"][t]
        assert abs(gap - want_gap[t]) < SCORE_GATE
    assert abs(sum(hit["scores"].values()) - 1.0) < 1e-6


def test_suffix_discard_budget_bounds_cache(setup):
    _, tcfg, _, tparams = setup
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(
        cache_capacity_tokens=1024, kv_keep_tokens=32), device="cpu")
    rng = np.random.default_rng(2)
    eng.submit(rng.integers(0, tcfg.vocab_size, 100).tolist())
    eng.run_until_drained()
    # only 32 tokens (2 blocks) of prefix KV may be resident
    assert eng.cache.used_blocks <= 32 // eng.ecfg.block_size
    k, v = next(iter(eng.cache.blocks.values())).payload
    assert k.shape == (tcfg.num_layers, 1, 16, tcfg.num_kv_heads,
                       tcfg.head_dim)


def test_scheduling_order_prioritizes_cache_hits(setup):
    _, tcfg, _, tparams = setup
    eng = PrefillOnlyEngine(tcfg, tparams,
                            EngineConfig(cache_capacity_tokens=4096, lam=0.0),
                            device="cpu")
    eng.jct_model.a, eng.jct_model.b = 1.0, 0.0   # deterministic JCT
    rng = np.random.default_rng(3)
    profile = rng.integers(0, tcfg.vocab_size, 64).tolist()
    eng.submit(profile + [1] * 8)
    eng.step()                                    # primes the cache
    short = eng.submit(rng.integers(0, tcfg.vocab_size, 40).tolist())
    shared = eng.submit(profile + [2] * 16)       # 80 tokens, 64 cached
    assert eng.run_until_drained() == [shared, short]   # miss 16 < 40


def test_probes_cancel_and_shedding(setup):
    _, tcfg, _, tparams = setup
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(lam=0.0),
                            device="cpu")
    eng.jct_model.a, eng.jct_model.b = 1e-3, 0.01
    toks = list(range(1, 81))
    first = eng.submit(toks)
    assert eng.pending_jct() == pytest.approx(1e-3 * 80 + 0.01)
    eng.step()
    chain = tpc.token_chain(toks, 16)
    # 80 tokens resident, bucketed reuse is 64 (prefix_bucket_blocks = 4)
    pending, predicted, cached = eng.probe(80, chain)
    assert (pending, cached) == (0.0, 80)
    assert predicted == pytest.approx(1e-3 * 16 + 0.01)
    late = eng.submit(toks, deadline=0.0)         # already unreachable
    keep = eng.submit(toks[:40])
    assert [r.req_id for r in eng.shed_expired(now=1.0)] == [late]
    assert eng.cancel(keep).req_id == keep and eng.cancel(keep) is None
    assert eng.step() is None and first in eng.results


def test_profile_run_fits_linear_model(setup):
    _, tcfg, _, tparams = setup
    eng = PrefillOnlyEngine(tcfg, tparams, EngineConfig(), device="cpu")
    r = eng.profile((32, 64, 128))
    assert eng.jct_model.a > 0 and np.isfinite(r)
    assert eng.forwards == 9


def test_engine_config_rejects_later_slices():
    """Packing and the offload tier take the reference's defaults."""
    got, want = EngineConfig(), jengine.EngineConfig()
    for name in ("max_pack_requests", "pack_token_budget",
                 "pack_prefix_budget", "prefix_buckets", "autotune_pack",
                 "pack_inflation", "shape_cost_model", "shape_pad_discount",
                 "offload", "host_cache_bytes", "offload_host_bw"):
        assert getattr(got, name) == getattr(want, name), name
    assert EngineConfig(offload=True).offload
    assert EngineConfig(max_pack_requests=2).max_pack_requests == 2


def test_default_device_raises_without_cuda(setup):
    """Entry points default to CUDA and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, _, tparams = setup
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        PrefillOnlyEngine(tcfg, tparams)
    with pytest.raises(RuntimeError):
        init_params(tcfg, torch.Generator())
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("n", [0, 15, 16, 17, 64, 100])
def test_copied_core_modules_match_reference(n):
    """The port's own copies of the framework-free reference modules give
    the reference's answers."""
    toks = list(range(7, 7 + n))
    assert tpc.token_chain(toks, 16) == jpc.token_chain(toks, 16)
    sizes = (64, 128, 256)
    assert tkv.bucket(n + 1, sizes) == jkv.bucket(n + 1, sizes)
    tk = tkv.KVLifecycle(block_size=16, kv_keep_tokens=48, buckets=sizes)
    jk = jkv.KVLifecycle(block_size=16, kv_keep_tokens=48, buckets=sizes)
    for m in (0, 1, 3):
        assert tk.resident(m, n) == jk.resident(m, n)
        assert tk.keep_new(n, 16 * m, m) == jk.keep_new(n, 16 * m, m)
    assert tk.suffix_keep_new(n, 16, 40) == jk.suffix_keep_new(n, 16, 40)
    assert tk.keep_pad(n, 128) == jk.keep_pad(n, 128)
    samples = [(64 + 32 * i + n, i % 3, 0.01 + 1e-4 * (64 + 32 * i))
               for i in range(8)]
    tl_, jl_ = tjct.LinearProxyJCT().fit(samples), jjct.LinearProxyJCT().fit(
        samples)
    assert (tl_.a, tl_.b, tl_.pearson_r) == (jl_.a, jl_.b, jl_.pearson_r)
    shape_samples = [(tjct.step_features(c, s, 0, 0, p), 1e-5 * s + 1e-3)
                     for c, s, p in [(40, 64, 0), (100, 128, 64),
                                     (200, 256, 0), (30, 64, 128)] * 5]
    ts = tjct.PackedShapeJCT().fit(shape_samples)
    js = jjct.PackedShapeJCT().fit(shape_samples)
    assert ts.predict(n, 128, 0, 0, 64) == js.predict(n, 128, 0, 0, 64)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    pkg = ROOT / "src" / "repro_torch"
    # kernels/build/ holds build outputs, not the package's sources
    files = sorted(p for p in pkg.rglob("*.py")
                   if "build" not in p.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
    code = ("import sys, repro_torch.core.engine, repro_torch.models.params, "
            "repro_torch.models.model, repro_torch.kernels.decode_attention, "
            "repro_torch.core.simulator, repro_torch.data.workloads, "
            "repro_torch.core.kv_policy, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.launch.smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
