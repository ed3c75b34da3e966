"""The launch plans of the tensor-core kernels, on the CPU.

``fused_mlp.mlp_plan`` (the MLP's tiles and d_ff split) and
``flash_attention.split_rule`` (the attention's key split) are plain
functions of shapes and the SM count, so they are held here without a card:
the grid covers every token, d_ff column, output column and key exactly
once, splits are whole tiles, the grid fills the H100's 132 SMs at the main
path's short shapes (a decode step's T = 16, a solo hit's 128 suffix tokens)
and does not split where it is already full (a 2048-token miss), at
qwen1.5-0.5b's widths and at granite-3-8b's (D 4096, d_ff 12,800; 32/8
heads of 128).
"""
import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm

H100_SMS = 132
# (T, D, F): the main path's token counts at qwen1.5-0.5b width, and the
# card tests' ragged shapes
MLP_SHAPES = [(16, 1024, 2816), (128, 1024, 2816), (512, 1024, 2816),
              (2048, 1024, 2816), (1, 32, 40), (100, 128, 352),
              (9, 512, 64), (513, 1024, 2816), (77, 96, 200),
              # granite-3-8b: a decode step (B 8), a solo hit, a packed
              # hit, a miss; the card tests' wide ragged shape
              (8, 4096, 12800), (128, 4096, 12800), (512, 4096, 12800),
              (2048, 4096, 12800), (77, 2048, 8192)]


def _cover(n: int, tile: int, blocks: int) -> np.ndarray:
    """How often each of n indices is covered by `blocks` tiles of `tile`
    (the last one masked at n)."""
    hits = np.zeros(blocks * tile, dtype=int)
    for b in range(blocks):
        hits[b * tile:(b + 1) * tile] += 1
    return hits[:n]


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 8])
@pytest.mark.parametrize("T,D,F", MLP_SHAPES)
def test_mlp_plan_covers_every_output_and_d_ff_row_once(T, D, F, n_sm):
    plan = fm.mlp_plan(T, D, F, n_sm)
    assert plan.gate_up in fm.GATE_UP_TILES
    for (bm, bn), N in ((plan.gate_up, F), (fm.DOWN_TILE, D)):
        rows = _cover(T, bm, -(-T // bm))
        cols = _cover(N, bn, -(-N // bn))
        assert (rows == 1).all() and (cols == 1).all()
    # the down product's d_ff split: whole BK slices, each row once
    assert plan.chunk % fm.BK == 0 and plan.splits >= 1
    assert (plan.splits - 1) * plan.chunk < F <= plan.splits * plan.chunk
    assert (_cover(F, plan.chunk, plan.splits) == 1).all()


@pytest.mark.parametrize("T", [16, 128])
def test_mlp_plan_fills_the_card_at_short_shapes(T):
    """A decode step (T = 16) and a solo hit (T = 128) stream the weights;
    both GEMMs' grids reach the SM count (the down product by its d_ff
    split)."""
    plan = fm.mlp_plan(T, 1024, 2816, H100_SMS)
    assert fm._blocks(T, 2816, plan.gate_up) >= H100_SMS
    assert fm._blocks(T, 1024, fm.DOWN_TILE) * plan.splits >= H100_SMS
    assert plan.splits > 1


@pytest.mark.parametrize("T", [8, 128])
def test_mlp_plan_splits_d_ff_at_granite_widths(T):
    """At granite-3-8b's width the down product has 32 column tiles, so a
    decode step (T = 8: 32 tiles) and a solo hit (T = 128: 64 tiles) split
    d_ff until the grid reaches the SMs; a miss (T = 2048: 1024 tiles) does
    not."""
    D, F = 4096, 12800
    plan = fm.mlp_plan(T, D, F, H100_SMS)
    assert fm._blocks(T, D, fm.DOWN_TILE) == 32 * -(-T // 64)
    assert plan.splits > 1
    assert fm._blocks(T, D, fm.DOWN_TILE) * plan.splits >= H100_SMS
    assert fm._blocks(T, F, plan.gate_up) >= H100_SMS
    assert fm.mlp_plan(2048, D, F, H100_SMS).splits == 1


def test_mlp_plan_does_not_split_a_full_grid():
    plan = fm.mlp_plan(2048, 1024, 2816, H100_SMS)
    assert plan.splits == 1 and plan.chunk >= 2816
    assert plan.gate_up == fm.GATE_UP_TILES[0]
    assert fm._blocks(2048, 1024, fm.DOWN_TILE) >= H100_SMS


# (B, Sq, H, Sk): solo miss, solo hit, packed miss, packed hit, the card
# tests' small and ragged shapes
ATTN_SHAPES = [(1, 2048, 16, 2048), (1, 128, 16, 1152), (1, 512, 16, 512),
               (1, 512, 16, 4608), (2, 300, 16, 300), (1, 96, 8, 200),
               (1, 8, 2, 8), (3, 40, 4, 100), (1, 48, 16, 1072),
               (1, 1, 1, 1),
               # granite-3-8b's 32 query heads: solo miss, solo hit, packed
               # hit, the card tests' head_dim 128 cases
               (1, 2048, 32, 2048), (1, 128, 32, 1152), (1, 512, 32, 4608),
               (1, 130, 32, 130), (1, 64, 32, 1088), (2, 100, 4, 100)]


@pytest.mark.parametrize("n_sm", [H100_SMS, 114, 8])
@pytest.mark.parametrize("B,Sq,H,Sk", ATTN_SHAPES)
def test_attention_split_covers_every_key_tile_once(B, Sq, H, Sk, n_sm):
    splits, chunk = fa.split_rule(B, Sq, H, Sk, n_sm)
    nk = -(-Sk // fa.BLOCK_K)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < nk <= splits * chunk
    # chunks are whole key tiles: each key falls in exactly one chunk
    keys = _cover(Sk, chunk * fa.BLOCK_K, splits)
    assert (keys == 1).all()


def test_attention_split_fills_the_card_at_the_solo_hit():
    """128 suffix queries over 1152 keys at 16 heads: 32 query blocks, so
    the keys are split until the grid reaches the SM count."""
    splits, _ = fa.split_rule(1, 128, 16, 1152, H100_SMS)
    assert -(-128 // fa.BLOCK_Q) * 16 * splits >= H100_SMS


def test_attention_split_fills_the_card_at_granite_hits():
    """granite-3-8b's solo hit (128 queries over 1152 keys, 32 heads: 64
    blocks) splits its keys to reach the SMs; its miss (S 2048: 1024
    blocks) and packed hit (Sq 512: 256 blocks) do not split."""
    splits, _ = fa.split_rule(1, 128, 32, 1152, H100_SMS)
    assert splits > 1 and 2 * 32 * splits >= H100_SMS
    assert fa.split_rule(1, 2048, 32, 2048, H100_SMS)[0] == 1
    assert fa.split_rule(1, 512, 32, 4608, H100_SMS)[0] == 1


@pytest.mark.parametrize("Sq,Sk", [(2048, 2048), (2048, 4096)])
def test_attention_split_leaves_a_full_grid_alone(Sq, Sk):
    assert fa.split_rule(1, Sq, 16, Sk, H100_SMS) == (
        1, -(-Sk // fa.BLOCK_K))


def test_tile_shapes_follow_the_dtype():
    """The executed-tile map's granularity is the kernel's: 64 x 64 for the
    bf16 tensor-core kernel, 32 x 32 for the f32 CUDA-core kernel."""
    import torch
    assert fa.tile_shape(torch.bfloat16) == (fa.BLOCK_Q, fa.BLOCK_K) == (
        64, 64)
    assert fa.tile_shape(torch.float32) == (fa.F32_BLOCK,) * 2 == (32, 32)
