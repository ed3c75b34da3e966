"""The launch plans of the tensor-core kernels, on the CPU.

``fused_mlp.mlp_plan`` (the MLP's tiles and d_ff split),
``flash_attention.split_rule`` (the attention's key split),
``decode_attention.split_rule`` (flash decoding's key split, which also
reads the resident blocks a SM of the kernel it plans for) and
``rmsnorm.launch_plan`` (warps a row, rows a block) are plain functions of
shapes and card numbers, so they are held here without a card:
the grid covers every token, d_ff column, output column and key exactly
once, splits are whole tiles, the grid fills the H100's 132 SMs at the main
path's short shapes (a decode step's T = 16, a solo hit's 128 suffix tokens)
and does not split where it is already full (a 2048-token miss), at
qwen1.5-0.5b's widths and at granite-3-8b's (D 4096, d_ff 12,800; 32/8
heads of 128). Flash decoding's chunks are whole key tiles and its grid
fills whole waves at the decode paths' shapes; RMSNorm's plan covers
every row and 16-byte vector once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import rmsnorm as rn

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
               (1, 130, 32, 130), (1, 64, 32, 1088), (2, 100, 4, 100),
               # gemma2-9b's 16 heads at its window's S 8192, its solo
               # hit, and the card tests' head_dim 96 and 256 cases
               (1, 8192, 16, 8192), (1, 128, 16, 1152), (1, 64, 8, 1088),
               (1, 130, 8, 130), (1, 8, 4, 8)]


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


# ---- flash decoding (B6) -------------------------------------------------------
# (B, S, H, KV, d): qwen1.5-0.5b's decode (G 1), granite-3-8b's (G 4, d 128),
# chip_smoke.py's G 8 case, the card tests' shapes
DECODE_SHAPES = [(16, 32768, 16, 16, 64), (8, 32768, 32, 8, 128),
                 (4, 8192, 16, 2, 64), (3, 4100, 16, 2, 64),
                 (2, 4100, 32, 8, 128), (1, 64, 4, 1, 64), (2, 1, 8, 4, 32),
                 (4, 32768, 4, 4, 64),
                 # phi3-mini-3.8b's decode (G 1, d 96) at S 32,768 and its
                 # depth run's 8,192; gemma2-9b's (G 2, d 256) over a full
                 # cache and its 4096-slot ring
                 (8, 32768, 32, 32, 96), (8, 8192, 32, 32, 96),
                 (8, 32768, 16, 8, 256), (8, 4096, 16, 8, 256)]


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("B,S,H,KV,d", DECODE_SHAPES)
def test_decode_split_covers_every_slot_once_in_whole_tiles(B, S, H, KV, d,
                                                            per_sm):
    plan = da.launch_plan(B, S, H, KV, torch.bfloat16, H100_SMS, per_sm)
    assert plan.chunk % da.KEY_TILE == 0 and plan.splits >= 1
    assert (plan.splits - 1) * plan.chunk < S <= plan.splits * plan.chunk
    assert (_cover(S, plan.chunk, plan.splits) == 1).all()
    assert plan.blocks == B * KV * plan.splits <= B * KV * da.MAX_SPLITS
    assert plan.waves == plan.blocks / (H100_SMS * per_sm)


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("B,S,KV", [(16, 32768, 16), (8, 32768, 8),
                                    (4, 8192, 2)])
def test_decode_split_fills_whole_waves(B, S, KV, per_sm):
    """qwen's, granite's and the G 8 shape: where the rows fit one wave the
    grid is one wave holding more than half the card's slots (never a few
    blocks spilt into a second wave, as a fixed 4 blocks a SM put 576
    blocks on 528 slots); where the rows alone fill a wave, the slots of the grid's waves
    hold the whole work but for at most 15%."""
    rows = B * KV
    splits, chunk = da.split_rule(rows, S, H100_SMS, per_sm)
    slots, tiles = H100_SMS * per_sm, S // da.KEY_TILE
    if rows <= slots:
        assert slots / 2 < rows * splits <= slots
    else:
        waves = -(-rows * splits // slots)
        assert rows * tiles >= 0.85 * waves * slots * (chunk // da.KEY_TILE)


def test_decode_split_reads_the_kernels_residency():
    """granite's decode at the tensor-core kernel's 2 blocks a SM runs one
    wave of 256 blocks (a fixed 4 blocks a SM made 576 on 528 slots);
    qwen's at the GEMV kernel's 7 keeps 768 blocks of 10,944 slots; more rows than a wave's slots split to even out the last."""
    assert da.split_rule(64, 32768, H100_SMS, 2) == (4, 8192)
    assert da.split_rule(64, 32768, H100_SMS, 3) == (6, 5504)
    assert da.split_rule(256, 32768, H100_SMS, 7) == (3, 10944)
    assert da.split_rule(300, 32768, H100_SMS, 2) == (7, 4736)


@pytest.mark.parametrize("G,dtype,kernel", [
    (1, torch.bfloat16, "gemv"), (2, torch.bfloat16, "tc"),
    (2, torch.float32, "gemv"),
    (4, torch.bfloat16, "tc"), (8, torch.bfloat16, "tc"),
    (3, torch.bfloat16, "tc"), (1, torch.float32, "gemv"),
    (4, torch.float32, "gemv")])
def test_decode_kernel_rule(G, dtype, kernel):
    """bf16 GQA takes the tensor-core kernel; G = 1 (qwen) and f32 the
    CUDA-core GEMV kernel."""
    assert da.kernel_rule(G, dtype) == kernel


# ---- RMSNorm (B1) ----------------------------------------------------------------
# (T, D): every T the main path runs at both models' D, the card tests'
# shapes and widths past one warp's registers
NORM_SHAPES = [(T, D) for D in (1024, 4096) for T in (8, 16, 128, 512,
                                                      1024, 2048)] + [
    (1, 32), (37, 96), (3, 4096), (5, 1536), (2, 8192), (1, 32768)]


@pytest.mark.parametrize("n_sm", [H100_SMS, 8])
@pytest.mark.parametrize("T,D,elem", [
    (T, D, elem) for T, D in NORM_SHAPES for elem in (2, 4)
    if rn.vector_rule(D, elem, D)])      # f32 D 32768 is the scalar's width
def test_rmsnorm_plan_covers_every_row_and_vector_once(T, D, elem, n_sm):
    vec = rn.VECTOR_BYTES // elem
    plan = rn.launch_plan(T, D, elem, n_sm)
    assert plan.vector and plan.threads <= rn.MAX_THREADS
    assert plan.vectors <= rn.MAX_VECTORS
    tpr = 32 * plan.warps_per_row
    assert plan.threads == tpr * plan.rows_per_block
    hits = np.zeros((plan.blocks * plan.rows_per_block, D // vec), int)
    for r_in in range(plan.rows_per_block):
        for t in range(tpr):
            for i in range(rn.MAX_VECTORS):
                c = t + i * tpr
                if c < D // vec:
                    hits[r_in::plan.rows_per_block, c] += 1
    assert (hits[:T] == 1).all()
    assert plan.blocks == -(-T // plan.rows_per_block)


def test_rmsnorm_plan_by_width():
    """One warp a row up to bf16 D 1024 (four rows a block where every SM
    still gets a block, else fewer), four warps a row at granite's D 4096
    (one row a block)."""
    assert rn.launch_plan(2048, 1024, 2, H100_SMS)[:3] == (True, 1, 4)
    assert rn.launch_plan(512, 1024, 2, H100_SMS)[:3] == (True, 1, 3)
    for T in (16, 128):                  # a decode step, a hit
        plan = rn.launch_plan(T, 1024, 2, H100_SMS)
        assert plan[:3] == (True, 1, 1) and plan.blocks == T
    assert rn.launch_plan(2048, 4096, 2, H100_SMS)[:3] == (True, 4, 1)
    assert rn.launch_plan(2048, 4096, 4, H100_SMS)[:3] == (True, 8, 1)
    assert rn.launch_plan(7, 100, 2, H100_SMS, vector=False) == rn.Plan(
        False, 0, 1, 7, rn.SCALAR_THREADS, 0)


@pytest.mark.parametrize("D,elem,stride,addr,vector", [
    (1024, 2, 1024, 0, True), (1000, 2, 1000, 0, True),
    (1020, 2, 1020, 0, False),           # D not whole 8-element vectors
    (1024, 2, 1028, 0, False),           # row stride not whole vectors
    (1024, 2, 1024, 2, False),           # base 2 bytes off
    (96, 4, 160, 0, True), (98, 4, 98, 0, False),
    (32768, 2, 32768, 0, True), (32776, 2, 32776, 0, False)])  # past 1024 threads
def test_rmsnorm_vector_rule(D, elem, stride, addr, vector):
    assert rn.vector_rule(D, elem, stride, addr, 0) is vector
