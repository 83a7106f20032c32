"""The launch plan of csrc/block_bwd.cu (rcot_torch/ops/block.py), on the CPU.

block_bwd_plan cuts the fused block backward (row 5) into launches, and
the kernels take the pieces as they are: each pixel sum (dW_out, dW_in,
dW_proj in the tail, dW_qkv in the head) runs over ranges of pixels, one
block each per output tile, whose partials a second launch adds in a fixed
order; a per-pixel product with too few output tiles to fill the card
splits its depth the same way; the LayerNorm backward likewise over its
own ranges of pixels. These tests
hold the plan at every training block shape of chip_smoke.py and at odd
ones (C = 6 with h = 15, widths that are no multiple of a tile, fewer than
512 pixels), on several cards: the ranges cover every pixel once, in order,
none empty and none over 512 pixels; the blocks come to about two an SM
unless the cap forbids; the sums workspace holds the largest partials any
launch stores; the copy widths divide their operands' widths and fit
their pointers; and the ints come in the order the kernel reads them.
"""

import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw

CARDS = (132, 1, 7, 200)
# (b, h, w, c) of every training block shape, B = 3, and odd ones
TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 20, 19, 6), (1, 9, 33, 384), (2, 7, 5, 1), (1, 1, 1, 5), (3, 11, 29, 48),
       (8, 600, 600, 144), (1, 13, 37, 96), (4, 250, 321, 192)]


def _hid(c):
    return int(c * 2.66)


def _sums(c, tail):
    """(m, n) of each pixel sum's output, in the plan's order."""
    hid = _hid(c)
    return [(c, hid), (2 * hid, c), (c, c)] if tail else [(3 * c, c)]


def _prods(c, tail):
    """(n, k) of the per-pixel products t, h, du, da; None where not run."""
    w = 2 * _hid(c) if tail else 3 * c
    return [(c, c), (w, c), (c, w), (c, c)] if tail else [None, (w, c), (c, w), None]


def _ranges_cover(pixels, ranges, per, cap):
    """Ranges [r * per, min((r + 1) * per, pixels)) cover [0, pixels) once
    and in order, none empty, none over cap."""
    assert 1 <= per <= cap and ranges >= 1
    starts = [r * per for r in range(ranges)]
    ends = [min(s + per, pixels) for s in starts]
    assert starts[0] == 0 and ends[-1] == pixels
    assert all(e > s for s, e in zip(starts, ends))
    assert all(ends[i] == starts[i + 1] for i in range(ranges - 1))


def _plan(b, h, w, c, tail, n_sm, vecs=(1, 1, 1)):
    width = 2 * _hid(c) if tail else 3 * c
    dw_conv = (vecs[2], *tdw.dwconv_tile(width, w, vecs[2]),
               tdw.dwconv_rows(b, h, w, width, vecs[2], n_sm, 3))
    dw_taps = (vecs[2], *tdw.dwconv_tile(width, w, vecs[2]),
               tdw.dwconv_rows(b, h, w, width, vecs[2], n_sm, 3, tdw.DTAPS_MAX_PIXELS))
    return tblock.block_bwd_plan(b, h, w, c, width, tail, n_sm, vecs, dw_conv, dw_taps)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_pixel_sums_cover_every_pixel_once_in_ranges_of_at_most_512(b, h, w, c, tail):
    pixels = b * h * w
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, tail, n_sm)
        for (m, n), per in zip(_sums(c, tail), plan.sum_per):
            ranges, per_ = tblock.sum_plan(m, n, pixels, n_sm)
            assert per == per_
            _ranges_cover(pixels, ranges, per, tblock.SUM_MAX_PIXELS)
            assert per % tblock.MM_STEP == 0
            tiles = -(-m // tblock.MM_TILE_M) * -(-n // tblock.MM_TILE_N)
            want = tblock.SUM_BLOCKS_PER_SM * n_sm
            if per < tblock.SUM_MAX_PIXELS:
                # the blocks fill about SUM_BLOCKS_PER_SM an SM, no more
                assert ranges * tiles < want + tiles
                assert (ranges - 1) * tiles < want
        assert plan.sum_per[len(_sums(c, tail)):] == (0,) * (3 - len(_sums(c, tail)))


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_split_products_cover_their_depth_once_in_whole_steps(b, h, w, c, tail):
    pixels = b * h * w
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, tail, n_sm)
        for nk, (splits, per) in zip(_prods(c, tail), plan.splits):
            if nk is None:
                assert (splits, per) == (1, 0)
                continue
            n, k = nk
            assert (splits, per) == tblock.split_plan(pixels, n, k, n_sm)
            assert per % tblock.MM_STEP == 0
            _ranges_cover(k, splits, per, max(per, k))
            tiles = -(-pixels // tblock.MM_TILE_M) * -(-n // tblock.MM_TILE_N)
            if splits > 1:
                # only where the tiles alone leave the card short, and no
                # more blocks than SUM_BLOCKS_PER_SM an SM
                assert per >= tblock.SPLIT_MIN_STEPS * tblock.MM_STEP
                assert splits * tiles <= tblock.SUM_BLOCKS_PER_SM * n_sm
            else:
                assert (2 * tiles > tblock.SUM_BLOCKS_PER_SM * n_sm
                        or -(-k // tblock.MM_STEP) < 2 * tblock.SPLIT_MIN_STEPS)


@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_layernorm_ranges_cover_every_pixel_once(b, h, w, c):
    pixels = b * h * w
    for n_sm in CARDS:
        fwd, per = tblock.ln_plan(pixels, n_sm)
        assert 1 <= fwd <= tblock.LN_BLOCKS_PER_SM * n_sm
        assert fwd <= -(-pixels // tblock.LN_WARPS)
        assert per % tblock.LN_WARPS == 0
        _ranges_cover(pixels, -(-pixels // per), per, tblock.SUM_MAX_PIXELS)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_the_sums_workspace_holds_every_partial(b, h, w, c, tail):
    pixels = b * h * w
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, tail, n_sm)
        needs = []
        for m, n in _sums(c, tail):
            ranges, _ = tblock.sum_plan(m, n, pixels, n_sm)
            needs.append(0 if ranges == 1 else ranges * m * n)
            assert tblock.sum_workspace_numel(m, n, pixels, n_sm) == needs[-1]
        for nk, (splits, _) in zip(_prods(c, tail), plan.splits):
            needs.append(0 if splits == 1 else splits * pixels * nk[0])
        needs.append(-(-pixels // plan.ln_per) * 2 * c)
        width = 2 * _hid(c) if tail else 3 * c
        tc, rows = plan.dw_taps[2], plan.dw_taps[3]
        needs.append(b * -(-h // rows) * -(-w // tc) * 9 * width)
        assert plan.sums_numel == max(needs)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
def test_the_ints_come_in_the_kernels_order(tail):
    plan = _plan(3, 16, 16, 384, tail, 132, vecs=(4, 1, 2))
    ints = plan.ints()
    assert len(ints) == tblock.PLAN_INTS == 28
    assert ints[:2] == (plan.ln_blocks, plan.ln_per)
    assert ints[2:5] == plan.sum_per
    assert ints[5:8] == (4, 1, 2)
    assert ints[8:16] == tuple(k for split in plan.splits for k in split)
    assert any(s > 1 for s, _ in plan.splits)  # the latent splits du
    assert ints[16:20] == (plan.dw_conv if tail else (0, 0, 0, 0))
    assert ints[20:24] == plan.dw_rot
    assert ints[24:28] == plan.dw_taps
    assert plan.dw_rot[0] == plan.dw_taps[0] == 2


# (width, pointers, copy width): the widest of 4, 2, 1 floats that divides
# the operand's width and that every pointer of its class is aligned to
@pytest.mark.parametrize("width,ptrs,vec", [
    (48, (0, 256, 1024), 4), (48, (0, 8), 2), (48, (0, 4), 1), (127, (0,), 1),
    (254, (0, 512), 2), (1020, (0, 16), 4), (2042, (0, 16), 2), (255, (16,), 1),
    (6, (8, 16), 2), (15, (0,), 1), (384, (4096, 12), 1)])
def test_copy_widths_fit_each_operands_width_and_alignment(width, ptrs, vec):
    got = tdw.dwconv_vec(width, *ptrs)
    assert got == vec
    assert width % got == 0 and all(p % (4 * got) == 0 for p in ptrs)


# C of each training level -> copy widths of its C-, h- and 2h-wide operands
# in aligned buffers: h = 127, 255 and 1,021 are odd (4-byte copies)
TRAIN_VECS = {48: (4, 1, 2), 96: (4, 1, 2), 192: (4, 2, 4), 384: (4, 1, 2)}


@pytest.mark.parametrize("c", sorted(TRAIN_VECS))
def test_the_widths_of_the_training_shapes_take_the_expected_copies(c):
    hid = _hid(c)
    assert tuple(tdw.dwconv_vec(k, 0, 256) for k in (c, hid, 2 * hid)) == TRAIN_VECS[c]
