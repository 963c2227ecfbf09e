"""The per-shape plans of the channel_mix, fused_linear_attention and
whole-step megakernel kernels.

Each wrapper hands its kernel a plan made by a pure Python function of the
shape (`channel_mix.plan`, `fused_linear_attention.plan`). Here, with no
card, every shape the main paths give the kernels (and ragged ones) must
get a plan whose shared memory fits a Hopper block (232,448 bytes) and
whose grid, laid out and walked as the kernel's entry point and kernels
do it (csrc/flow_kernels.cu: channel_mix_f32, csrc/linear_attention.cu:
fused_linear_attention_f32 and fused_linear_attention_bwd_f32), covers
every row or token exactly once. The attention backward's plan
(`fused_linear_attention.bwd_plan`) must fit and take the fused layout at
N <= BWD_FUSED_MAX_N wherever it fits, and two or more blocks a batch row
above; its grids' coverage is held on the card at ragged N. The card tests
test_attention_plan_smem_matches_the_kernel and
test_attention_bwd_plan_smem_matches_the_kernel hold `smem_bytes` and
`bwd_smem_bytes` against the kernels' own sums. The megakernel's plan
(`step_megakernel.plan`) must fit, walk every pixel exactly once in runs
of 16 mt, stage y_a on every in-image neighbour its conv1 reads, keep the
scatter zeroconv's columns within a warp's tiles, and report a halo waste
equal to a pixel-by-pixel count (test_step_megakernel_smem_matches_the_kernel
holds its `smem_bytes` against the kernel's).
"""

import numpy as np
import pytest

from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
from nfdpm_tpu_torch.ops.kernels import fused_linear_attention as fla
from nfdpm_tpu_torch.ops.kernels import step_megakernel as sm

MAX_SMEM = 232448
CM_GENERIC_THREADS = 256  # csrc/flow_kernels.cu: the generic kernel's block
BATCH, VLB_ROWS = 64, 32  # chip_smoke.py: sampling and training at 64, VLB 4 x 8

# Glow L3 at 32x32x3, batch 64: (rows, C = O) of each level, and a ragged case
LEVELS = [(64 * 16 * 16, 12), (64 * 8 * 8, 24), (64 * 4 * 4, 48)]
CM_CASES = [(n, c, c) for n, c in LEVELS] + [(555, 14, 20), (555, 20, 14), (3, 192, 192)]

# The linear-attention calls of one evaluation of the three UNets of
# configs/nf_diffusion.yaml (parts 16x16, 8x8, 4x4; per part at side H:
# (H, 64), (H/2, 64), (H/2, 128), (H, 64)) as (N, C).
UNET_CALLS = [(s * s, c) for h in (16, 8, 4)
              for s, c in ((h, 64), (h // 2, 64), (h // 2, 128), (h, 64))]
FLA_CASES = ([(BATCH, n, c) for n, c in UNET_CALLS]        # sampling and training
             + [(VLB_ROWS, n, c) for n, c in UNET_CALLS]   # VLB scoring
             + [(5, n, 20) for n in (1, 15, 63, 64, 65, 257)]  # ragged, both sides of 64
             + [(3, 16, 7), (2, 16, 200), (2, 300, 256)])


def _blocks(p, n):
    return -(-n // p.rows_per_block)


def _square_coverage(p, n, c):
    """(row, output group) counts of the square kernel's thread layout:
    rows_per_block * G threads a block, RW rows a warp, 32 / RW groups a
    warp, WPC warps per RW rows."""
    outputs, rw = cm.SQUARE[c]
    groups = c // outputs
    wpc = groups // (32 // rw)
    tid = np.arange(p.rows_per_block * groups)
    wid, lane = tid // 32, tid % 32
    grp = (wid % wpc) * (32 // rw) + lane // rw
    counts = np.zeros((n, groups), np.int64)
    for blk in range(_blocks(p, n)):
        rows = blk * p.rows_per_block + rw * (wid // wpc) + lane % rw
        ok = rows < n
        np.add.at(counts, (rows[ok], grp[ok]), 1)
    return counts


def _generic_coverage(p, n, c_out):
    counts = np.zeros((n, c_out), np.int64)
    for blk in range(_blocks(p, n)):
        row0 = blk * p.rows_per_block
        rows = min(p.rows_per_block, n - row0)
        for tid in range(CM_GENERIC_THREADS):
            i = np.arange(tid, rows * c_out, CM_GENERIC_THREADS)
            np.add.at(counts, (row0 + i // c_out, i % c_out), 1)
    return counts


@pytest.mark.parametrize("n,c_in,c_out", CM_CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_channel_mix_plan_fits_and_covers_every_output_once(n, c_in, c_out, aligned):
    p = cm.plan(n, c_in, c_out, aligned)
    assert p.rows_per_block > 0
    if p.variant:
        assert aligned and c_in == c_out == p.variant
        outputs, rw = cm.SQUARE[p.variant]
        assert p.rows_per_block % rw == 0
        assert p.rows_per_block * (c_in // outputs) <= cm.MAX_THREADS
        assert 4 * (c_in * c_in + c_in) <= MAX_SMEM  # the staged weight and bias
        counts = _square_coverage(p, n, c_in)
    else:
        counts = _generic_coverage(p, n, c_out)
    assert (counts == 1).all()


def test_channel_mix_plan_at_the_glow_levels():
    """The level shapes take the square kernel; blocks shrink until the
    grid fills the 132 SMs or a block has one warp's rows (32 at C = 12
    and 24, 16 at C = 48)."""
    got = [cm.plan(n, c, c) for n, c in LEVELS]
    assert [p.variant for p in got] == [12, 24, 48]
    assert [_blocks(p, n) for p, (n, _) in zip(got, LEVELS)] == [256, 128, 64]
    assert cm.plan(1024, 48, 48, aligned=False).variant == 0
    assert cm.plan(555, 14, 20).variant == 0


def _fla_coverage(p, b, n):
    """Token counts of the forward's grid: fused, B blocks, block b takes
    batch row b's N tokens in its m_tiles 16-row tiles; split, both passes
    on (ceil(N / SPLIT_TOK), B) blocks of SPLIT_TOK tokens."""
    counts = np.zeros((b, n), np.int64)
    if p.fused:
        assert n <= 16 * p.m_tiles
        for row in range(b):
            counts[row] += 1
        return counts
    assert 16 * p.m_tiles == fla.SPLIT_TOK
    for tile in range(-(-n // fla.SPLIT_TOK)):
        for row in range(b):
            counts[row, tile * fla.SPLIT_TOK: (tile + 1) * fla.SPLIT_TOK] += 1
    return counts


@pytest.mark.parametrize("b,n,c", FLA_CASES, ids=lambda v: str(v))
def test_attention_plan_fits_and_covers_every_token_once(b, n, c):
    p = fla.plan(n, c)
    assert p is not None and fla.smem_bytes(p.fused, p.m_tiles, c) <= MAX_SMEM
    assert p.fused == (n <= fla.FUSED_MAX_N)
    assert (_fla_coverage(p, b, n) == 1).all()


def test_attention_plan_at_the_served_shapes():
    """One batch row a fused block at the served N = 4, 16 and 64 (1, 1 and
    4 tensor-core row tiles); at N = 256 the split plan, 64-token tiles. No
    plan beyond C = 256."""
    assert fla.plan(4, 64) == (True, 1)
    assert fla.plan(16, 128) == (True, 1)
    assert fla.plan(64, 128) == (True, 4)
    assert fla.plan(256, 64) == (False, 4)
    assert fla.plan(16, 300) is None


# The attention backward: the 12 calls of a stage-2 train step at batch 64,
# the ragged case of chip_smoke.py, both sides of N = 64, and C up to MAX_C
# at the N of each plan
BWD_CASES = ([(BATCH, n, c) for n, c in UNET_CALLS] + [(5, 15, 20)]
             + [(5, n, 20) for n in (1, 63, 64, 65, 257)]
             + [(2, n, c) for c in (1, 7, 64, 65, 96, 128, 129, 200, fla.MAX_C)
                for n in (4, 48, 64, 300)])


@pytest.mark.parametrize("b,n,c", BWD_CASES, ids=lambda v: str(v))
def test_attention_bwd_plan_fits_and_covers_every_token_once(b, n, c):
    """The plan fits a block and is the one its rule names; a fused plan
    holds all N tokens of a batch row. That the kernels' grids then cover
    every token and batch row exactly once is held on the card, against the
    plain version at ragged N (7, 15, 65, 100, 257) in
    tests/test_torch_kernels_cuda.py."""
    p = fla.bwd_plan(n, c)
    assert p is not None and fla.bwd_smem_bytes(p.fused, p.m_tiles, c) <= MAX_SMEM
    fused = fla.Plan(True, -(-n // 16))
    if n <= fla.BWD_FUSED_MAX_N and fla.bwd_smem_bytes(True, fused.m_tiles, c) <= MAX_SMEM:
        assert p == fused
    elif n <= fla.SPLIT_TOK:
        assert p == (False, 2)
    else:
        assert not p.fused and p.m_tiles in (2, 4)
    assert not p.fused or (p.m_tiles <= 2 and n <= 16 * p.m_tiles)


def test_attention_bwd_fused_plan_holds_at_most_two_row_tiles():
    """The backward's fused kernel exists for one and two 16-token row tiles
    only (csrc/linear_attention.cu refuses more), so every N <= 64 at every
    C is given a fused plan of at most two tiles that holds all its tokens,
    or a split plan of 32-token tiles."""
    for c in (1, 20, 64, 128, 200, fla.MAX_C):
        for n in range(1, fla.SPLIT_TOK + 1):
            p = fla.bwd_plan(n, c)
            assert p in ((True, 1), (True, 2), (False, 2)), (n, c, p)
            assert not p.fused or n <= 16 * p.m_tiles <= fla.BWD_FUSED_MAX_N


def test_attention_bwd_plan_at_the_training_shapes():
    """Fused at the 6 calls of a train step with N <= 32 (one batch row a
    block); split into 32-token tiles at the 4 with N = 64 (two blocks a
    row) and into 64-token tiles at the 2 with N = 256; 32-token tiles
    above C = 128; nothing beyond C = 256."""
    plans = [fla.bwd_plan(n, c) for n, c in UNET_CALLS]
    assert sum(p.fused for p in plans) == 6
    assert fla.bwd_plan(256, 64) == (False, 4)
    assert fla.bwd_plan(64, 64) == (False, 2)
    assert fla.bwd_plan(64, 128) == (False, 2)
    assert fla.bwd_plan(33, 128) == (False, 2)
    assert fla.bwd_plan(16, 128) == (True, 1)
    assert fla.bwd_plan(4, 64) == (True, 1)
    assert fla.bwd_plan(32, 128) == (True, 2)
    assert fla.bwd_plan(300, 200) == (False, 2)
    assert fla.bwd_plan(16, 300) is None


# (B, H, W, C, width): the three level shapes of the served Glow (batch 64,
# width 512), the JAX package's test case, a ragged case (odd B, H and W, C
# and width not multiples of 8) and blocks of four whole images
MEGA_CASES = [(64, 16, 16, 12, 512), (64, 8, 8, 24, 512), (64, 4, 4, 48, 512),
              (5, 16, 16, 12, 64), (7, 5, 9, 14, 44), (16, 2, 2, 48, 512)]


@pytest.mark.parametrize("b,h,w,c,d", MEGA_CASES)
def test_megakernel_plan_fits_and_covers_every_pixel_once(b, h, w, c, d):
    """The plan as csrc/step_megakernel.cu walks it: block i takes the
    pixels [16 mt i, 16 mt (i + 1)) of the flattened [B, H, W], stages y_a
    on [first - W - 1, first + 16 mt + W + 1) and runs conv1 on its own
    pixels; its products run on all 16 mt rows."""
    p = sm.plan(b, h, w, c, d)
    assert p is not None and p.mt in (1, 2, 4) and p.stages in (2, 3, 4)
    assert p.smem == sm.smem_bytes(w, c, d, p.mt, p.stages) <= MAX_SMEM
    assert -(-sm.z_cols(c) // 64) <= 8 // p.mt  # the zeroconv's columns: a warp's tiles
    n, m = b * h * w, 16 * p.mt
    covered = np.zeros(n, np.int64)
    rows_run = 0
    for blk in range(p.blocks):
        first = blk * m
        own = np.arange(first, min(first + m, n))
        covered[own] += 1
        rows_run += m
        # every in-image neighbour that conv1 reads lies in the staged range
        pix = own % (h * w)
        for dh in (-1, 0, 1):
            for dw in (-1, 0, 1):
                inside = ((pix // w + dh >= 0) & (pix // w + dh < h)
                          & (pix % w + dw >= 0) & (pix % w + dw < w))
                q = own[inside] + dh * w + dw
                assert ((q >= first - w - 1) & (q < first + m + w + 1)).all()
    assert (covered == 1).all()
    assert sm.halo_waste(p, b, h, w) == rows_run / n


def test_megakernel_plan_at_the_level_shapes():
    """A block per 64, 32 and 16 pixels at the three levels: 256, 128 and 64
    blocks, two waves, one and one of one block an SM; no halo; the deepest
    ring that fits (stages of 32 rows, 16 at mt = 1)."""
    plans = [sm.plan(*shape) for shape in MEGA_CASES[:3]]
    assert [(p.mt, p.blocks, p.stages) for p in plans] == [(4, 256, 4), (2, 128, 4),
                                                            (1, 64, 4)]
    assert [sm.halo_waste(p, *shape[:3]) for p, shape in zip(plans, MEGA_CASES)] == [1.0] * 3
    assert [sm.z_cols(c) for c in (12, 24, 48, 14)] == [112, 216, 432, 128]


def test_megakernel_plan_refuses_what_the_kernel_does_not_take():
    assert sm.plan(2, 4, 4, 7, 16) is None      # odd C
    assert sm.plan(2, 4, 4, 8, 18) is None      # a width not a multiple of 4
    assert sm.plan(2, 4, 4, 8, 8192) is None    # h1 too wide for shared memory
    assert sm.plan(2, 4, 4, 64, 512) is None    # 9 C past a warp's column tiles
    assert sm.plan(0, 4, 4, 8, 16) is None
