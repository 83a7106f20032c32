"""The launch plans of csrc/fused_dwconv.cu (rcot_torch/ops/fused.py) and
the channel limit of the block kernels' LayerNorm (ops/block.py), on the CPU.

fused_fwd_plan and fused_bwd_plan cut rows 8-9 (the qkv configuration,
dw3x3(x @ W_in^T), and the GDFN's, (gelu(c1) c2) @ W_out^T) into launches,
and the kernels take the pieces as they are: the K ranges of each
per-pixel product (h and the GDFN's W_out product forward, h and dx
backward), the pixel ranges of each pixel sum (dW_out, dW_in), the gate
taken in the W_out product or as a pass of its own, row 11's plans of the
depthwise forward and dtaps, and the copy width of each width class. These
tests hold the plans at every training block shape of chip_smoke.py and at
odd ones (C = 6 with h = 15, widths that are no multiple of a tile, fewer
than 128 pixels, the served L1 shapes), on cards of 132, 1, 7 and 200 SMs:
the products cover their depth once in whole steps; the pixel sums cover
every pixel once in ranges of at most 512; the workspaces hold what the
launches store; the ints come in the kernel's order; the copy widths fit
every operand at odd h (127, 255, 1,021) and at offset pointers; and the
gate is fused exactly where C <= GATE_FUSED_MAX_C. The block kernels'
LayerNorm holds any C up to LN_MAX_CHANNELS (its backward's partials in
227 KB of shared memory), 576, 768 and 2,048 among them.
"""

import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import fused as tfused

CARDS = (132, 1, 7, 200)
TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 20, 19, 6), (1, 9, 33, 384), (2, 7, 5, 1), (1, 1, 1, 5), (3, 11, 29, 48),
       (1, 256, 256, 48), (1, 256, 256, 96), (1, 32, 41, 384), (1, 12, 12, 576)]
SHAPES = TRAIN + ODD
GDFN = pytest.mark.parametrize("gdfn", [False, True], ids=["qkv", "gdfn"])


def _hid(c):
    return int(c * 2.66)


def _width(c, gdfn):
    return 2 * _hid(c) if gdfn else 3 * c


def _dw(b, h, w, width, n_sm, vec, dtaps):
    cap = tdw.DTAPS_MAX_PIXELS if dtaps else 0
    return (vec, *tdw.dwconv_tile(width, w, vec),
            tdw.dwconv_rows(b, h, w, width, vec, n_sm, 3, cap))


def _fwd(b, h, w, c, gdfn, n_sm, vecs=(1, 1, 1), vec_m=1):
    width = _width(c, gdfn)
    return tfused.fused_fwd_plan(b, h, w, c, width, gdfn, n_sm, vecs,
                                 _dw(b, h, w, width, n_sm, vec_m, False))


def _bwd(b, h, w, c, gdfn, n_sm, vecs=(1, 1, 1)):
    width = _width(c, gdfn)
    return tfused.fused_bwd_plan(b, h, w, c, width, gdfn, n_sm, vecs,
                                 _dw(b, h, w, width, n_sm, vecs[2], False),
                                 _dw(b, h, w, width, n_sm, vecs[2], True))


def _fwd_prods(c, gdfn):
    """(n, k) of the forward's products h and out; None where not run."""
    width = _width(c, gdfn)
    return [(width, c), (c, width // 2) if gdfn else None]


def _bwd_prods(c, gdfn):
    """(n, k) of the backward's products h and dx."""
    width = _width(c, gdfn)
    return [(width, c), (c, width)]


def _bwd_sums(c, gdfn):
    """(m, n) of the pixel sums dW_out and dW_in; None where not run."""
    width = _width(c, gdfn)
    return [(c, width // 2) if gdfn else None, (width, c)]


def _ranges_cover(total, ranges, per, cap):
    """Ranges [r * per, min((r + 1) * per, total)) cover [0, total) once
    and in order, none empty, none over cap."""
    assert 1 <= per <= cap and ranges >= 1
    starts = [r * per for r in range(ranges)]
    ends = [min(s + per, total) for s in starts]
    assert starts[0] == 0 and ends[-1] == total
    assert all(e > s for s, e in zip(starts, ends))
    assert all(ends[i] == starts[i + 1] for i in range(ranges - 1))


@GDFN
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_each_product_covers_its_depth_once_in_whole_steps(b, h, w, c, gdfn):
    pixels = b * h * w
    for n_sm in CARDS:
        for plan, prods in ((_fwd(b, h, w, c, gdfn, n_sm), _fwd_prods(c, gdfn)),
                            (_bwd(b, h, w, c, gdfn, n_sm), _bwd_prods(c, gdfn))):
            assert len(plan.splits) == 2
            for nk, (splits, per) in zip(prods, plan.splits):
                if nk is None:
                    assert (splits, per) == (1, 0)
                    continue
                n, k = nk
                assert (splits, per) == tblock.split_plan(pixels, n, k, n_sm)
                assert per % tblock.MM_STEP == 0
                _ranges_cover(k, splits, per, max(per, k))
                if splits > 1:
                    tiles = -(-pixels // tblock.MM_TILE_M) * -(-n // tblock.MM_TILE_N)
                    assert per >= tblock.SPLIT_MIN_STEPS * tblock.MM_STEP
                    assert splits * tiles <= tblock.SUM_BLOCKS_PER_SM * n_sm


@GDFN
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_every_pixel_sum_range_holds_at_most_512_pixels(b, h, w, c, gdfn):
    pixels = b * h * w
    for n_sm in CARDS:
        plan = _bwd(b, h, w, c, gdfn, n_sm)
        for mn, per in zip(_bwd_sums(c, gdfn), plan.sum_per):
            if mn is None:
                assert per == 0
                continue
            ranges, per_ = tblock.sum_plan(*mn, pixels, n_sm)
            assert per == per_ and per % tblock.MM_STEP == 0
            _ranges_cover(pixels, ranges, per, tblock.SUM_MAX_PIXELS)


@GDFN
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_workspaces_hold_what_the_launches_store(b, h, w, c, gdfn):
    pixels, width = b * h * w, _width(c, gdfn)
    hid = width // 2
    # forward: h (the h product's output, then a gate pass's rows of
    # gate_ld(h) floats), conv (the depthwise's); the qkv configuration's h
    fwd = tfused.fwd_workspace_numel(pixels, width, gdfn)
    want = ((pixels * max(width, -(-hid // 4) * 4), pixels * width) if gdfn
            else (pixels * width,))
    assert len(fwd) == len(want) and all(have >= need for have, need in zip(fwd, want))
    # backward: h, conv then dh, dconv (the gate's backward), gate; the qkv
    # configuration's h and dh
    bwd = tfused.bwd_workspace_numel(pixels, width, gdfn)
    want = ((pixels * width,) * 3 + (pixels * hid,) if gdfn else (pixels * width,) * 2)
    assert len(bwd) == len(want) and all(have >= need for have, need in zip(bwd, want))
    for n_sm in CARDS:
        plan = _fwd(b, h, w, c, gdfn, n_sm)
        needs = [0] + [s * pixels * nk[0] for nk, (s, _) in
                       zip(_fwd_prods(c, gdfn), plan.splits) if nk is not None and s > 1]
        assert plan.sums_numel == max(needs)
        plan = _bwd(b, h, w, c, gdfn, n_sm)
        needs = [tblock.sum_workspace_numel(*mn, pixels, n_sm)
                 for mn in _bwd_sums(c, gdfn) if mn is not None]
        needs += [s * pixels * nk[0] for nk, (s, _) in zip(_bwd_prods(c, gdfn), plan.splits)
                  if s > 1]
        tc, rows = plan.dw_taps[2], plan.dw_taps[3]
        needs.append(b * -(-h // rows) * -(-w // tc) * 9 * width)
        assert plan.sums_numel == max(needs)


@GDFN
def test_the_ints_come_in_the_kernels_order(gdfn):
    # the serving latent: few tiles, so the GDFN's W_out product splits
    fwd = _fwd(1, 32, 32, 384, gdfn, 132, vecs=(4, 2, 4), vec_m=2)
    ints = fwd.ints()
    assert len(ints) == tfused.FWD_PLAN_INTS == 13
    assert ints[0] == fwd.gate_blocks == tblock.ln_plan(32 * 32, 132)[0]
    assert ints[1:4] == (4, 2, 4)
    assert ints[4:8] == tuple(k for split in fwd.splits for k in split)
    assert [s > 1 for s, _ in fwd.splits] == [False, gdfn]
    assert ints[8:12] == fwd.dw_conv and fwd.dw_conv[0] == 2
    assert ints[12] == fwd.gate_pass == int(gdfn)  # C = 384: six output tiles
    bwd = _bwd(1, 32, 32, 384, gdfn, 132, vecs=(4, 2, 1))
    ints = bwd.ints()
    assert len(ints) == tfused.BWD_PLAN_INTS == 21
    assert ints[0:2] == bwd.sum_per and (bwd.sum_per[0] > 0) == gdfn
    assert ints[2:5] == (4, 2, 1)
    assert ints[5:9] == tuple(k for split in bwd.splits for k in split)
    assert ints[9:13] == bwd.dw_conv == (bwd.dw_rot if gdfn else (0, 0, 0, 0))
    assert ints[13:17] == bwd.dw_rot and ints[17:21] == bwd.dw_taps
    assert bwd.dw_taps[3] * bwd.dw_taps[2] <= tdw.DTAPS_MAX_PIXELS or bwd.dw_taps[3] == 1


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_gate_is_fused_exactly_where_c_fits_one_output_tile(b, h, w, c):
    for n_sm in CARDS:
        assert _fwd(b, h, w, c, True, n_sm).gate_pass == int(c > tfused.GATE_FUSED_MAX_C)
        assert _fwd(b, h, w, c, False, n_sm).gate_pass == 0
    assert tfused.GATE_FUSED_MAX_C == tblock.MM_TILE_N


def _rows_fit(base, ld, start, extent, vec, rows=5):
    """Copies of vec floats along `extent` floats from base + start, at
    rows of pitch ld, are each wholly inside the row and 4 vec-byte aligned."""
    return extent % vec == 0 and all(
        (base + 4 * (r * ld + start + k)) % (4 * vec) == 0
        for r in range(rows) for k in range(0, extent, vec))


# (h, pointer of W_out) -> the copy width of the h class (either half of
# conv, a workspace on a 512-byte boundary, W_out's rows, the gate); a gate
# pass's rows lie gate_ld(h) floats apart, 16-byte copies at any h
@pytest.mark.parametrize("hid,w_out,vec", [
    (127, 0, 1), (255, 1024, 1), (1021, 256, 1), (510, 0, 2), (510, 8, 2), (510, 4, 1),
    (128, 0, 4), (15, 0, 1), (256, 48, 4), (256, 40, 2)])
def test_the_h_class_copies_fit_both_halves_of_conv_w_out_and_the_gate(hid, w_out, vec):
    c = 48
    for bwd in (False, True):
        ptrs = {"x": 0, "w_in": 512, "w_out": w_out, **({"g": 1024} if bwd else {"out": 1024})}
        vec_c, vec_h, vec_g, vec_m = tfused.fused_vecs(c, 2 * hid, True, ptrs)
        assert vec_h == vec and vec_c == 4
        conv = 2048  # any workspace: 512-byte aligned
        assert _rows_fit(conv, 2 * hid, 0, hid, vec_h)    # c1
        assert _rows_fit(conv, 2 * hid, hid, hid, vec_h)  # c2
        assert _rows_fit(conv, hid, 0, hid, vec_h)        # the backward's gate
        assert _rows_fit(w_out, hid, 0, hid, vec_h)
        ld = tblock.gate_ld(hid)  # a gate pass's copies may run into the zero pad
        assert vec_g == 4 and _rows_fit(conv, ld, 0, ld, vec_g)
        assert _rows_fit(conv, 2 * hid, 0, 2 * hid, vec_m)


# the C class (x, W_in and the GDFN's g) and the M class (the qkv
# configuration's g and out, and every workspace): the widest copy that the
# width divides and every pointer of the class allows
@pytest.mark.parametrize("c,offset", [(48, 0), (48, 4), (48, 8), (6, 0), (5, 0), (384, 12)])
@pytest.mark.parametrize("name", ["x", "w_in", "g", "out"])
@GDFN
def test_the_c_and_m_class_copies_fit_every_operand(c, offset, name, gdfn):
    width = _width(c, gdfn)
    ptrs = {"x": 0, "w_in": 1024, "g": 2048, "out": 4096}
    if gdfn:
        ptrs["w_out"] = 8192
    ptrs[name] += offset
    vec_c, vec_h, vec_g, vec_m = tfused.fused_vecs(c, width, gdfn, ptrs)
    c_class = ("x", "w_in", "g") if gdfn else ("x", "w_in")
    m_class = () if gdfn else ("g", "out")
    for k in c_class:
        assert _rows_fit(ptrs[k], c, 0, c, vec_c)
    for k in m_class:
        assert _rows_fit(ptrs[k], width, 0, width, vec_m)
    assert _rows_fit(0, width, 0, width, vec_m)  # the workspaces
    assert vec_c == tdw.dwconv_vec(c, offset if name in c_class else 0)
    assert vec_m == tdw.dwconv_vec(width, offset if name in m_class else 0)
    if not gdfn:
        assert (vec_h, vec_g) == (1, 1)


# ------------------------------------------------------ the LayerNorm's C

def _ln_smem_bytes(c):
    """Shared memory of a block of the LayerNorm backward: its warps'
    partials of dln_w and dln_b, LN_WARPS * 2C floats."""
    return 4 * tblock.LN_WARPS * 2 * c


@pytest.mark.parametrize("c", [1, 48, 384, 512, 513, 576, 768, 1024, 1536, 2048, 3632])
def test_the_block_kernels_take_any_c_their_layernorm_holds(c):
    tblock._check_channels(c)
    assert _ln_smem_bytes(c) <= tblock.SMEM_BYTES
    # past 48 KB (the attribute is raised once per device) from C = 769 on
    assert (_ln_smem_bytes(c) > 48 * 1024) == (c > 768)


def test_the_layernorm_limit_is_what_a_block_s_shared_memory_holds():
    assert tblock.LN_MAX_CHANNELS == 3632
    assert _ln_smem_bytes(tblock.LN_MAX_CHANNELS) <= tblock.SMEM_BYTES
    assert _ln_smem_bytes(tblock.LN_MAX_CHANNELS + 1) > tblock.SMEM_BYTES
    with pytest.raises(ValueError, match=str(tblock.LN_MAX_CHANNELS)):
        tblock._check_channels(tblock.LN_MAX_CHANNELS + 1)


@pytest.mark.parametrize("c", [576, 768, 1024, 2048])
@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
def test_the_block_plans_at_wide_c_hold_the_layernorm_sums(c, tail):
    b, h, w = 1, 12, 12
    pixels = b * h * w
    width = 2 * _hid(c) if tail else 3 * c
    for n_sm in CARDS:
        plan = tblock.block_bwd_plan(b, h, w, c, width, tail, n_sm, (1, 1, 1),
                                     _dw(b, h, w, width, n_sm, 1, False),
                                     _dw(b, h, w, width, n_sm, 1, True))
        # one partial dln_w, dln_b (2C floats) per LayerNorm block
        assert plan.sums_numel >= -(-pixels // plan.ln_per) * 2 * c
        _ranges_cover(pixels, -(-pixels // plan.ln_per), plan.ln_per, tblock.SUM_MAX_PIXELS)
