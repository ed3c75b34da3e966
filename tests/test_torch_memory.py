"""The port's prefill memory model (``repro_torch.core.kv_policy.MemoryModel``),
its chip constants and the config quantities the model reads, held against
the JAX package's on the same inputs; then the reference's memory-model
behaviours (``tests/test_jct_and_policy.py``) on the H100.

Configs are bridged field for field: the port's ``ModelConfig`` built from
the reference's fields, for every dense config of the reference registry
(llama3.1-8b included), for the vlm and audio configs, which take the
dense formulas, and for the moe configs, which count their experts, router
and shared expert. Chips the same way: a port ``ChipSpec`` equal to the
TPU v5e field for field, and a reference ``ChipSpec`` carrying the H100's
constants, so both packages price both chips. Real numbers agree within
rel 1e-12 (the copy runs the same float operations), integers exactly.
"""
import dataclasses
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs.registry import REGISTRY
from repro.core.kv_policy import MemoryModel as RefMemoryModel
from repro.runtime import hw as ref_hw
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_policy import MemoryModel
from repro_torch.runtime import hw
from repro_torch.runtime.hw import H100_SXM, ChipSpec

REL = 1e-12
DENSE = sorted(a for a, c in REGISTRY.items() if c.family == "dense")
# the vlm and audio families run the dense formulas (internvl2-2b,
# musicgen-large), the moe family the reference's MoE terms (mixtral-8x22b,
# llama4-scout-17b-a16e); SSM and hybrid configs raise
VLM_AUDIO = sorted(a for a, c in REGISTRY.items()
                   if c.family in ("vlm", "audio"))
MOE = sorted(a for a, c in REGISTRY.items() if c.family == "moe")
OTHER = sorted(a for a, c in REGISTRY.items()
               if c.family not in ("dense", "vlm", "audio", "moe"))
TECHNIQUES = ("paged", "chunked", "discard", "hybrid", "tp", "pp")
LENGTHS = (0, 1, 1000, 16_384, 19_000, 60_000, 524_288)


def port_config(ref) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    assert names == {f.name for f in dataclasses.fields(ref)}
    return ModelConfig(**{n: getattr(ref, n) for n in names})


def port_chip(ref) -> ChipSpec:
    return ChipSpec(**{f.name: getattr(ref, f.name)
                       for f in dataclasses.fields(ChipSpec)})


def ref_chip(port) -> ref_hw.ChipSpec:
    return ref_hw.ChipSpec(**{f.name: getattr(port, f.name)
                              for f in dataclasses.fields(ChipSpec)})


V5E = port_chip(ref_hw.TPU_V5E)
# (reference chip, port chip) pairs with the same constants
CHIPS = ((ref_hw.TPU_V5E, V5E), (ref_chip(H100_SXM), H100_SXM))
LLAMA = port_config(REGISTRY["llama3.1-8b"])


def close(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0.0)


def models(arch, **kw):
    """(reference, port) memory models of ``arch`` on each chip."""
    for rchip, pchip in CHIPS:
        yield (RefMemoryModel(REGISTRY[arch], rchip, **kw),
               MemoryModel(port_config(REGISTRY[arch]), pchip, **kw))


# ---- chip and configs ------------------------------------------------------

def test_chip_fields_are_the_references():
    ref_names = {f.name for f in dataclasses.fields(ref_hw.ChipSpec)}
    assert {f.name for f in dataclasses.fields(ChipSpec)} <= ref_names
    # vmem_bytes (a TPU core's vector memory) is read by no model
    assert ref_names - {f.name for f in dataclasses.fields(ChipSpec)} == {
        "vmem_bytes"}
    for f in dataclasses.fields(ChipSpec):
        assert getattr(V5E, f.name) == getattr(ref_hw.TPU_V5E, f.name)


def test_h100_constants():
    # the total an NVIDIA H100 80GB HBM3 reports (torch.cuda.mem_get_info);
    # chip_smoke.py holds the card's reading to it within 1%
    assert H100_SXM.hbm_bytes == 85_017_493_504
    assert H100_SXM.ici_bw == 450e9         # NVLink 4, one direction
    assert H100_SXM.host_bw == 64e9         # PCIe Gen5 x16, one direction
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bw) == (989e12, 3.35e12)


@pytest.mark.parametrize("rchip,pchip", CHIPS, ids=("v5e", "h100"))
def test_roofline_helpers_match_reference(rchip, pchip):
    for nbytes in (1.0, 3e9, 7.5e12):
        close(hw.memory_seconds(nbytes, pchip),
              ref_hw.memory_seconds(nbytes, 1, rchip))
        close(hw.compute_seconds(nbytes, pchip),
              ref_hw.compute_seconds(nbytes, 1, rchip))
        for chips in (1, 2, 4):
            close(hw.collective_seconds(nbytes, pchip, chips),
                  ref_hw.collective_seconds(nbytes, chips, rchip))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_quantities_match_reference(arch):
    ref = REGISTRY[arch]
    cfg = port_config(ref)
    for name in ("has_attention", "is_attention_free", "ssm_heads",
                 "d_ff_shared", "d_inner", "has_ssm", "is_moe"):
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for b in (1, 2, 4):
        assert cfg.kv_bytes_per_token(b) == ref.kv_bytes_per_token(b)


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    cfg = port_config(REGISTRY[arch])
    assert cfg.has_attention == REGISTRY[arch].has_attention
    with pytest.raises(NotImplementedError):
        cfg.active_param_count()
    with pytest.raises(NotImplementedError):
        MemoryModel(cfg, H100_SXM).peak_bytes(1000, "hybrid")


@pytest.mark.parametrize("arch", VLM_AUDIO)
def test_vlm_and_audio_memory_match_reference(arch):
    """The vlm and audio configs price as the reference prices them: the
    config quantities, every technique's peak, the MIL table and the
    prefix budgets, on both chips."""
    _memory_matches_reference(arch)


@pytest.mark.parametrize("arch", MOE)
def test_moe_memory_matches_reference(arch):
    """The moe configs price as the reference prices them (their parameter
    counts hold every expert, their active counts the routed ones), with
    the same checks as the vlm and audio configs'."""
    assert REGISTRY[arch].is_moe
    assert (REGISTRY[arch].active_param_count()
            < REGISTRY[arch].param_count())
    _memory_matches_reference(arch)


def _memory_matches_reference(arch):
    ref = REGISTRY[arch]
    cfg = port_config(ref)
    assert cfg == get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.kv_bytes_per_token() == ref.kv_bytes_per_token()
    for kw in (dict(), dict(weight_bytes_per_param=1.0)):
        for rmm, pmm in models(arch, **kw):
            for t in TECHNIQUES:
                for S in LENGTHS:
                    for keep in (None, 16_384):
                        close(pmm.peak_bytes(S, t, 2048, 2, kv_keep=keep),
                              rmm.peak_bytes(S, t, 2048, 2, kv_keep=keep))
            for chunk, k in ((2048, 2), (512, 4)):
                assert pmm.mil_table(chunk, k) == rmm.mil_table(chunk, k)
            for mil in (0, 19_000, 60_000, 10**6):
                for keep in (None, 0, 16_384):
                    assert (pmm.prefix_budget_tokens(mil, 2048, keep)
                            == rmm.prefix_budget_tokens(mil, 2048, keep))


def test_the_port_registry_is_bridged():
    for arch in ("qwen1.5-0.5b", "granite-3-8b", "llama3.1-8b",
                 "internvl2-2b", "musicgen-large", "mixtral-8x22b",
                 "llama4-scout-17b-a16e"):
        assert port_config(REGISTRY[arch]) == get_config(arch)


def test_chip_is_required():
    with pytest.raises(TypeError):
        MemoryModel(get_config("qwen1.5-0.5b"))


# ---- MemoryModel against the reference ---------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_per_token_coefficients_match_reference(arch):
    for kw in (dict(), dict(weight_bytes_per_param=1.0),
               dict(output_prealloc=False), dict(inplace=False),
               dict(output_prealloc=False, inplace=False)):
        for ref, port in models(arch, **kw):
            for name in ("weights_bytes", "kv_all_per_token",
                         "kv_one_layer_per_token", "mlp_int_per_token",
                         "attn_stream_per_token"):
                close(getattr(port, name), getattr(ref, name))
            close(port.budget_bytes(), ref.budget_bytes())


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_peak_bytes_matches_reference(arch, technique):
    for kw in (dict(), dict(weight_bytes_per_param=1.0, inplace=False),
               dict(output_prealloc=False, utilization=0.8)):
        for ref, port in models(arch, **kw):
            for S in LENGTHS:
                for chunk in (512, 2048):
                    for k in (2, 4):
                        for keep in (None, 0, 1000, 16_384):
                            close(port.peak_bytes(S, technique, chunk, k,
                                                  kv_keep=keep),
                                  ref.peak_bytes(S, technique, chunk, k,
                                                 kv_keep=keep))
    with pytest.raises(ValueError):
        port.peak_bytes(1, "ring")


@pytest.mark.parametrize("arch", DENSE)
def test_max_input_length_matches_reference_on_both_branches(arch):
    """``kv_keep`` puts a knee in the hybrid peak: past it the kept slice is
    a constant (long-input branch, the MIL lies above kv_keep), below it the
    slice grows with S (short-input branch, the MIL lies at or below it).
    Both branches are reached and equal the reference's."""
    branches = set()
    for kw in (dict(), dict(weight_bytes_per_param=1.0)):
        for ref, port in models(arch, **kw):
            for t in TECHNIQUES:
                for chunk in (512, 2048):
                    assert (port.max_input_length(t, chunk, 2)
                            == ref.max_input_length(t, chunk, 2))
            for keep in (16, 16_384, 10**6, 10**8):
                got = port.max_input_length("hybrid", kv_keep=keep)
                assert got == ref.max_input_length("hybrid", kv_keep=keep)
                branches.add(got > keep)
    assert branches == {True, False}


@pytest.mark.parametrize("arch", DENSE)
def test_prefix_budget_and_mil_table_match_reference(arch):
    for kw in (dict(), dict(weight_bytes_per_param=1.0)):
        for ref, port in models(arch, **kw):
            for mil in (0, 19_000, 60_000, 10**6, 10**8):
                for keep in (None, 0, 16_384):
                    for chunk in (512, 2048):
                        assert (port.prefix_budget_tokens(mil, chunk, keep)
                                == ref.prefix_budget_tokens(mil, chunk, keep))
            for chunk, k in ((2048, 2), (512, 4)):
                assert port.mil_table(chunk, k) == ref.mil_table(chunk, k)


def test_h100_mil_of_the_port_models():
    """What chip_smoke.py prints beside its measured peaks: the closed form
    on the H100's 85.0e9 bytes, and the per-token bytes its slopes are
    held to (one layer's K/V and streams; every layer's K/V)."""
    want = {"qwen1.5-0.5b": ((610_052, 2_545_390, 4_099_655), 18_432, 98_304),
            "granite-3-8b": ((231_353, 599_629, 1_222_110), 49_152,
                             163_840)}
    for arch, (mils, per_token, kv_all) in want.items():
        mm = MemoryModel(get_config(arch), H100_SXM)
        table = mm.mil_table()
        assert (table["paged"], table["discard"], table["hybrid"]) == mils
        assert mm.kv_one_layer_per_token + mm.attn_stream_per_token == \
            per_token
        assert mm.kv_all_per_token == kv_all
        assert mm.prefix_budget_tokens(60_000) > 300_000


# ---- the reference's behaviours (tests/test_jct_and_policy.py) on the H100 --

def test_mil_ordering_matches_paper_on_h100():
    """Table 2's ordering on one accelerator holds on the 80 GB card too:
    paged < discard-only < chunked < hybrid; TP-2 > paged."""
    mil = MemoryModel(LLAMA, H100_SXM, weight_bytes_per_param=1.0).mil_table()
    assert mil["paged"] < mil["discard"]
    assert mil["paged"] < mil["chunked"]
    assert mil["chunked"] < mil["hybrid"]
    assert mil["hybrid"] > 2 * mil["paged"]
    assert mil["tp"] > mil["paged"]


def test_discard_alone_is_marginal_on_h100():
    mil = MemoryModel(LLAMA, H100_SXM, weight_bytes_per_param=1.0).mil_table()
    assert mil["discard"] / mil["paged"] < 2.5


def test_mlp_intermediates_dominate_one_layer_kv():
    mm = MemoryModel(LLAMA, H100_SXM)
    assert 10 < mm.mlp_int_per_token / mm.kv_one_layer_per_token < 20


def test_prefix_budget_positive_at_workload_mil_on_h100():
    mm = MemoryModel(LLAMA, H100_SXM, weight_bytes_per_param=1.0)
    assert mm.prefix_budget_tokens(20_000) > 10_000


def test_hybrid_micro_optimizations_increase_mil_on_h100():
    base = MemoryModel(LLAMA, H100_SXM, weight_bytes_per_param=1.0,
                       output_prealloc=False, inplace=False)
    opt = MemoryModel(LLAMA, H100_SXM, weight_bytes_per_param=1.0)
    assert opt.max_input_length("hybrid") >= base.max_input_length("hybrid")
    assert opt.peak_bytes(32_768, "paged") < base.peak_bytes(32_768, "paged")


# ---- the port's forward against the model (CPU, live tensors) ----------------

class _LiveBytes(TorchDispatchMode):
    """Bytes of tensor storage alive, and their peak, over the ops run
    under it. A kernel wrapper's call counts as its outputs only (on the
    card it is one kernel; on the CPU its plain version makes f32
    temporaries the kernel never holds)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.paused = False
        self._seen = set()

    def track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key, n = st.data_ptr(), st.nbytes()
            if n == 0 or key in self._seen:
                continue
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self.live -= n
        self._seen.discard(key)

    def boxed(self, fn):
        def call(*args, **kwargs):
            self.paused = True
            try:
                out = fn(*args, **kwargs)
            finally:
                self.paused = False
            self.track(out)
            return out
        return call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            self.track(out)
        return out


def _forward_peak(monkeypatch, cfg, params, S, kv_keep=0):
    from repro_torch.kernels import flash_attention, fused_mlp, rmsnorm
    from repro_torch.models import transformer
    mode = _LiveBytes()
    for mod, name in ((rmsnorm, "rmsnorm"), (fused_mlp, "fused_mlp"),
                      (flash_attention, "flash_attention")):
        monkeypatch.setattr(mod, name, mode.boxed(getattr(mod, name)))
    toks = torch.randint(0, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(S))
    with torch.no_grad(), mode:
        out = transformer.prefill(params, cfg, {"tokens": toks},
                                  kv_keep=kv_keep)
        del out
    monkeypatch.undo()
    return mode.peak


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "granite-3-8b"))
def test_forward_peak_per_token_within_the_model(monkeypatch, arch):
    """The layer-wise discard and hybrid prefilling as the model prices
    them: over S, the bytes ``prefill`` holds at its peak grow by no more
    a token than one layer's streams and K/V (``MemoryModel``'s hybrid
    slope) with ``hybrid_chunk`` on, by more with it off, and a kept slice
    of ``kv_keep`` tokens adds exactly ``kv_keep`` tokens of every layer's
    K/V. The forward before its repair (ROADMAP C9: the previous layer's
    K/V held through the next layer, RoPE's f32 temporaries at full S,
    three residual streams a layer) read 1.86x (qwen) and 2.0x (granite)
    the model's slope here, the same with the chunk on and off."""
    from repro_torch.configs import reduce_config
    from repro_torch.models.params import init_params
    slopes = {}
    for chunk in (32, 0):
        cfg = reduce_config(get_config(arch), hybrid_chunk=chunk)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        peaks = {S: _forward_peak(monkeypatch, cfg, params, S)
                 for S in (256, 1024)}
        slopes[chunk] = (peaks[1024] - peaks[256]) / 768
        mm = MemoryModel(cfg, H100_SXM)
        kept = _forward_peak(monkeypatch, cfg, params, 1024, kv_keep=512)
        assert kept - peaks[1024] == 512 * mm.kv_all_per_token
    model = mm.peak_bytes(1, "hybrid") - mm.peak_bytes(0, "hybrid")
    assert slopes[32] <= model
    assert slopes[32] < slopes[0]
