"""Model configuration (copy of ``repro.configs.base.ModelConfig``).

The config is a frozen dataclass so it can key per-shape caches safely.
"""
from __future__ import annotations

import dataclasses

# The families the port runs: the reference's transformer, whose vlm and
# audio configs are dense blocks with an untied head (vlm may take
# precomputed embeddings in place of token ids), whose moe configs
# replace each block's MLP with a mixture of experts (``models/moe.py``),
# and whose local_global configs (gemma2) pair a sliding-window layer with
# a global one.
PORTED_FAMILIES = ("dense", "vlm", "audio", "moe")
# The ROADMAP item that brings each family the port refuses.
UNPORTED = {"ssm": "A6, SSM and hybrid (models/mamba2.py)",
            "hybrid": "A6, SSM and hybrid (models/hybrid.py)"}


def _unported_family(cfg: "ModelConfig"):
    """``cfg``'s family where the port does not run it yet (SSM, hybrid),
    else None."""
    return None if cfg.family in PORTED_FAMILIES else cfg.family


def check_ported(cfg: "ModelConfig") -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, unless the
    port runs ``cfg``: a family of ``PORTED_FAMILIES`` (with or without
    local/global layer pairs)."""
    what = _unported_family(cfg)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {'/'.join(PORTED_FAMILIES)} "
            f"families; {what} comes with ROADMAP "
            f"{UNPORTED.get(what, 'A6')}")


def refuse_local_global(cfg: "ModelConfig", what: str) -> None:
    """Raise ``NotImplementedError`` for a local_global config at ``what``
    (the engine, the prefix-cache hit forwards): the reference has no
    local/global branch there (its engine reads ``kv["k"]`` and its hit
    forwards scan ``params["blocks"]``, which a local_global tree lacks),
    so the port would add a feature the reference lacks (ROADMAP §C20)."""
    if cfg.local_global:
        raise NotImplementedError(
            f"{cfg.name}: {what} does not run local_global configs; the "
            f"reference has no local/global branch there (ROADMAP §C20)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (decoder-only LM backbone).

    ``family`` drives block selection: dense, moe, ssm, hybrid, vlm,
    audio. The port runs ``PORTED_FAMILIES`` (``check_ported``); an moe
    config's blocks take a mixture of experts in place of the MLP.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # --- attention features ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0            # 0 = full attention
    local_global: bool = False         # gemma2: alternate local(SWA)/global
    attn_softcap: float = 0.0          # gemma2: tanh softcap on attn logits
    final_softcap: float = 0.0         # gemma2: tanh softcap on LM logits

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    shared_expert: bool = False        # llama4-style always-on expert
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256               # SSD chunk length
    attn_every: int = 0                # hybrid: shared attn block cadence

    # --- embeddings / io ---
    embed_inputs: bool = True          # False: inputs arrive as embeddings (vlm)
    tie_embeddings: bool = True

    # --- execution ---
    packed_attention: bool = False     # exact-causal tile packing (perf)
    dtype: str = "bfloat16"            # activations / compute
    param_dtype: str = "bfloat16"      # stored weights (serving)
    hybrid_chunk: int = 2048           # PrefillOnly hybrid prefilling chunk (0 = off)
    remat: bool = True                 # activation checkpointing for train
    logits_chunk: int = 2048           # chunked LM-head/xent (0 = off)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_ff_shared(self) -> int:
        """FFN width of the shared attention block (hybrid family)."""
        return self.d_ff if self.d_ff else 4 * self.d_model

    def _dense_formula(self, what: str) -> None:
        """The quantities below are the reference's formulas for the ported
        families (local_global configs count the same); an SSM or hybrid
        config raises, naming its ROADMAP item."""
        fam = _unported_family(self)
        if fam is not None:
            raise NotImplementedError(
                f"{what} for family {fam!r} comes with ROADMAP "
                f"{UNPORTED.get(fam, 'A6')}")

    def param_count(self) -> int:
        """Analytic parameter count: an MoE layer holds every expert, the
        router and the shared expert."""
        self._dense_formula("param_count")
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        embed = V * D
        lm_head = 0 if self.tie_embeddings else V * D
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        mlp = 3 * D * F
        if self.is_moe:
            mlp = mlp * self.num_experts + D * self.num_experts  # + router
            if self.shared_expert:
                mlp += 3 * D * F
        per_layer = attn + mlp + 2 * D
        return embed + lm_head + L * per_layer + D

    def active_param_count(self) -> int:
        """Parameters touched per token: an MoE config counts only its
        ``num_experts_per_tok`` routed experts a layer."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        all_expert = L * (3 * D * F) * self.num_experts
        active_expert = L * (3 * D * F) * self.num_experts_per_tok
        return self.param_count() - all_expert + active_expert

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per token across all layers (ported families)."""
        self._dense_formula("kv_bytes_per_token")
        return self.num_layers * 2 * self.num_kv_heads * self.head_dim * bytes_per_el
