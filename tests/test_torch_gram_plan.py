"""The launch plans of csrc/gram.cu (rcot_torch/ops/gram.py), on the CPU.

Each plan cuts a kernel's work into contiguous pieces by the card's SM
count, and the kernel takes the pieces as they are: the Gram forward's
pixel ranges of each (b, head) (gram_plan), the apply forward's runs of
tiles (apply_plan) and the apply backward's dattn pixel ranges
(dattn_plan). These tests hold each at every block shape of chip_smoke.py
and at odd ones, for several SM counts: the pieces cover the work exactly
once with none empty, in whole kernel stages, and the blocks stay within
the waves each design states. The Gram's workspace is one partial
G | nq | nk per range when a (b, head) is split, and none otherwise.
"""

import pytest

import chip_smoke
from rcot_torch.ops import gram as tgram

H100_SMS = 132
SM_COUNTS = (H100_SMS, 1, 7, 200)

# (b, hw, heads, ch) of every block shape of chip_smoke.py's serving (B = 1)
# and training (B = 3) paths
MAIN = [(1, res * res, heads, c // heads) for _, res, c, heads in chip_smoke.MAIN_SHAPES]
MAIN += [(chip_smoke.TRAIN_B, res * res, heads, c // heads)
         for _, res, c, heads in chip_smoke.TRAIN_SHAPES]
ODD = [(2, 9, 2, 5), (2, 33 * 7, 4, 24), (3, 33 * 7, 1, 5), (3, 257, 3, 48),
       (1, 1, 1, 1), (1, 64 * 64, 1, 128), (2, 16 * 16, 4, 96), (3, 8 * 9, 1, 128),
       (1, 65536, 8, 48), (3, 100_000, 1, 24), (4, 1000, 64, 8), (1, 131, 2, 7)]


def _tiles_once(work, pieces, per):
    """`pieces` runs of `per` cover [0, work) once, the last one not empty."""
    assert pieces >= 1 and per >= 1
    assert per * (pieces - 1) < work <= per * pieces


def test_the_main_path_shapes_are_the_sixteen_of_chip_smoke():
    """(L3 and noise_level2 share a shape, as do their training twins.)"""
    assert len(MAIN) == 16 and len(set(MAIN)) == 14


@pytest.mark.parametrize("b,hw,heads,ch", sorted(set(MAIN)) + ODD)
def test_every_plan_covers_its_work_once_within_its_waves(b, hw, heads, ch):
    bh = b * heads
    for n_sm in SM_COUNTS:
        splits, per = tgram.gram_plan(b, hw, heads, n_sm)
        _tiles_once(hw, splits, per)
        n = tgram.GRAM_BLOCKS_PER_SM * n_sm
        assert per <= tgram.GRAM_MAX_PIXELS
        if per < tgram.GRAM_MAX_PIXELS:
            assert splits == 1 if bh >= n else splits * bh <= n + bh - 1
        assert splits == 1 or per % tgram.GRAM_PIXEL_STEP == 0
        assert tgram.gram_workspace_numel(splits, b, heads, ch) == (
            0 if splits == 1 else splits * bh * (ch * ch + 2 * ch))

        tiles = bh * -(-hw // tgram.APPLY_TILE)
        blocks, per = tgram.apply_plan(b, hw, heads, ch, n_sm)
        _tiles_once(tiles, blocks, per)
        assert blocks <= (2 if ch <= tgram.APPLY_TWO_MAX_CH else 1) * n_sm

        blocks, per = tgram.dattn_plan(b, hw, heads, n_sm)
        _tiles_once(hw, blocks, per)
        assert per % tgram.DATTN_STAGE == 0
        assert blocks * bh <= max(tgram.DATTN_BLOCKS_PER_SM * n_sm + bh - 1, bh)


def test_the_large_shapes_fill_the_card():
    """At the 256^2 level-1 shapes (one head) the Gram's ranges give every
    SM one block but four; at the training latent (24 pairs of 256 pixels)
    each pair splits into four 64-pixel ranges, and a pair that alone
    fills the card is not split, so it needs no workspace. Batch 8 at L1
    would give ranges of 3,904 pixels: they are cut to 512. The apply at
    serve L1 (512 tiles, ch = 48) runs 256 blocks of two tiles, at decoder
    L1 (ch = 96) 128 blocks of four."""
    assert tgram.gram_plan(1, 256 * 256, 1, H100_SMS) == (128, 512)
    assert tgram.gram_plan(3, 16 * 16, 8, H100_SMS) == (4, 64)
    assert tgram.gram_workspace_numel(4, 3, 8, 48) == 4 * 24 * (48 * 48 + 96)
    assert tgram.gram_plan(3, 16 * 16, 44, H100_SMS) == (1, 256)
    assert tgram.gram_workspace_numel(1, 3, 44, 48) == 0
    assert tgram.gram_plan(8, 256 * 256, 1, H100_SMS) == (128, 512)
    assert tgram.apply_plan(1, 256 * 256, 1, 48, H100_SMS) == (256, 2)
    assert tgram.apply_plan(1, 256 * 256, 1, 96, H100_SMS) == (128, 4)
