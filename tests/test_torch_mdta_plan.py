"""The launch plan of csrc/mdta.cu (rcot_torch/ops/mdta.py mdta_plan), on the CPU.

The fused MDTA attend runs three launches on the plan of a pure function
of the shape and the SM count: the Gram's pixel ranges (each block one
range of one (bh, channel-block pair)), the channel blocks of a head, the
apply's runs of 128-pixel tiles, and the softmax's warps. These tests hold
it at every block shape of chip_smoke.py's serving (B = 1 and 2) and
training (B = 3) paths, at odd pixel counts and at heads wider than 128
channels, for several SM counts: the ranges cover [0, N) once, in whole
64-pixel stages of at most 512 pixels; the blocks cover [0, c) once, at
most 128 channels each; the apply's runs cover every tile once within
their waves; the workspace holds the slots, one record a range and P; the
copies are 16 bytes where N and every pointer allow and 4 otherwise.
"""

import pytest

import chip_smoke
from rcot_torch.ops import gram as tgram
from rcot_torch.ops import mdta as tmdta

H100_SMS = 132
SM_COUNTS = (H100_SMS, 1, 7, 200)

# (b, heads, c, n) of every block shape of chip_smoke.py's serving and
# training paths
MAIN = [(b, heads, c // heads, res * res) for _, res, c, heads in chip_smoke.MAIN_SHAPES
        for b in (1, 2)]
MAIN += [(chip_smoke.TRAIN_B, heads, c // heads, res * res)
         for _, res, c, heads in chip_smoke.TRAIN_SHAPES]
# odd and ragged N (80,250: a 250x321 image unpadded), tiny and wide heads,
# the one-head-a-level model's 192 and 384
ODD = [(1, 1, 48, 80250), (1, 1, 48, 20125), (2, 4, 24, 231), (1, 2, 5, 9), (1, 1, 1, 1),
       (1, 1, 128, 1000), (2, 1, 136, 999), (1, 2, 192, 4096), (3, 1, 384, 256),
       (3, 1, 150, 300), (1, 1, 257, 64), (8, 1, 48, 65536)]


def _covers_once(work, pieces, per):
    """`pieces` runs of `per` cover [0, work) once, the last one not empty."""
    assert pieces >= 1 and per >= 1
    assert per * (pieces - 1) < work <= per * pieces


def test_the_shapes_are_chip_smokes_sixteen_at_both_serving_batches():
    assert len(MAIN) == 24 and len(set(MAIN)) == 21


@pytest.mark.parametrize("b,heads,c,n", sorted(set(MAIN)) + ODD)
def test_the_plan_covers_every_pixel_channel_and_tile_once(b, heads, c, n):
    bh = b * heads
    for n_sm in SM_COUNTS:
        plan = tmdta.mdta_plan(b, heads, c, n, n_sm)
        # the Gram's ranges: whole stages, at most 512 pixels, every pixel once
        _covers_once(n, plan.splits, plan.per)
        assert plan.per <= tgram.GRAM_MAX_PIXELS and plan.per % tgram.GRAM_PIXEL_STEP == 0
        # the channel blocks: every channel once, at most 128 each
        _covers_once(c, plan.blocks, plan.width)
        assert plan.width <= tgram.HEAD_BLOCK
        pairs = plan.blocks ** 2
        # the grid of ranges comes to about one block an SM, pairs and heads
        # counted alike, unless the ranges would pass 512 pixels
        if plan.per < tgram.GRAM_MAX_PIXELS and bh * pairs < n_sm:
            assert plan.splits * bh * pairs <= n_sm + bh * pairs - 1
        # the apply's runs: every 128-pixel tile of every bh once, for each pair
        _covers_once(bh * -(-n // tmdta.MDTA_APPLY_TILE), plan.apply_blocks, plan.apply_per)
        per_sm = 2 if plan.width <= tmdta.MDTA_APPLY_TWO_MAX_CH else 1
        assert plan.apply_blocks <= per_sm * max(1, n_sm // pairs)
        assert 1 <= plan.warps <= min(plan.splits, tmdta.MDTA_SOFTMAX_WARPS)
        # one workspace: the slots of out (a head of several blocks), a
        # record G | nq | nk per range and bh, and P
        slots = plan.blocks * bh * c * n if plan.blocks > 1 else 0
        assert tmdta.mdta_workspace_numel(plan, b, heads, c, n) == (
            slots + plan.splits * bh * (c * c + 2 * c) + bh * c * c)


@pytest.mark.parametrize("c,blocks,width", [(1, 1, 1), (5, 1, 5), (48, 1, 48), (96, 1, 96),
                                            (128, 1, 128), (129, 2, 65), (136, 2, 68),
                                            (150, 2, 75), (192, 2, 96), (257, 3, 86),
                                            (260, 3, 88), (384, 3, 128)])
def test_a_head_is_cut_into_blocks_of_at_most_128(c, blocks, width):
    """Heads of ch <= 128 are one block; wider ones as few blocks as 128
    allows, of about equal width, a multiple of 4 where c is."""
    plan = tmdta.mdta_plan(1, 1, c, 4096, H100_SMS)
    assert (plan.blocks, plan.width) == (blocks, width) == tgram.channel_blocks(c)


def test_the_main_path_plans_on_an_h100():
    """Serve L1 (65,536 pixels, one head of 48): 128 ranges of 512 pixels,
    the apply on 256 blocks of two tiles (two an SM), the softmax on 32
    warps, four ranges each; train L1 (B = 3): 43 ranges of 384 a bh;
    decoder L1 (c = 96): one apply block an SM; a head of 384 at the
    latent: three blocks of 128, nine pairs that share the card."""
    assert tmdta.mdta_plan(1, 1, 48, 65536, H100_SMS) == (128, 512, 1, 48, 256, 2, 32)
    assert tmdta.mdta_plan(3, 1, 48, 16384, H100_SMS) == (43, 384, 1, 48, 192, 2, 32)
    assert tmdta.mdta_plan(1, 1, 96, 65536, H100_SMS) == (128, 512, 1, 96, 128, 4, 32)
    assert tmdta.mdta_plan(1, 1, 384, 1024, H100_SMS) == (8, 128, 3, 128, 8, 1, 8)
    plan = tmdta.mdta_plan(1, 1, 48, 65536, H100_SMS)
    assert tmdta.mdta_workspace_numel(plan, 1, 1, 48, 65536) == 128 * (48 * 48 + 96) + 48 * 48


@pytest.mark.parametrize("n,ptrs,vec", [(65536, (0, 256, 4096), 4), (80250, (0, 256), 1),
                                        (20125, (0,), 1), (1024, (0, 4), 1),
                                        (1024, (16, 32, 48), 4), (4, (0,), 4), (9, (0,), 1)])
def test_copies_are_16_bytes_where_every_row_is_aligned(n, ptrs, vec):
    """16-byte copies need N % 4 == 0 (every row starts 16 bytes after the
    last one's start) and every tensor 16-byte aligned; else 4-byte ones."""
    assert tmdta.mdta_vec(n, *ptrs) == vec
