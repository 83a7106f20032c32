"""The launch plan of csrc/block_fwd.cu (rcot_torch/ops/block.py), on the CPU.

block_fwd_plan cuts the fused block forward (rows 1-2) into launches, and
the kernels take the pieces as they are: the LayerNorm forward's blocks,
the K ranges of each per-pixel product (the tail's t, h and gated W_out
product, the head's qkv product), whose partials a second launch adds in a
fixed order where a product's tiles alone leave the card short, and row
11's plan of the depthwise forward. These tests hold the plan at every
serving and training block shape of chip_smoke.py and at odd ones (C = 6
with h = 15, widths that are no multiple of a tile, fewer than 128 pixels,
the 250x321 and nine-tile 600x600 images), on cards of 132, 1, 7 and 200
SMs: the K ranges cover K once, in order, in whole steps; the workspaces
hold what the launches store; the copy widths divide their operands'
widths and fit their pointers, each half of conv's rows included where h is
odd (127, 255, 1,021); and the ints come in the order the kernel reads
them.
"""

import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw

CARDS = (132, 1, 7, 200)
SERVE = [(b, res, res, c) for _, res, c, _ in chip_smoke.MAIN_SHAPES for b in (1, 2)]
TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 20, 19, 6), (1, 9, 33, 384), (2, 7, 5, 1), (1, 1, 1, 5), (3, 11, 29, 48),
       (1, 256, 328, 48), (1, 32, 41, 384), (9, 256, 256, 96), (8, 256, 256, 48)]
SHAPES = SERVE + TRAIN + ODD


def _hid(c):
    return int(c * 2.66)


def _width(c, tail):
    return 2 * _hid(c) if tail else 3 * c


def _prods(c, tail):
    """(n, k) of the per-pixel products t, h and out; None where not run."""
    w = _width(c, tail)
    return [(c, c), (w, c), (c, w // 2)] if tail else [None, (w, c), None]


def _plan(b, h, w, c, tail, n_sm, vecs=(1, 1, 1), vec_m=1):
    width = _width(c, tail)
    dw_conv = (vec_m, *tdw.dwconv_tile(width, w, vec_m),
               tdw.dwconv_rows(b, h, w, width, vec_m, n_sm, 3))
    return tblock.block_fwd_plan(b, h, w, c, width, tail, n_sm, vecs, dw_conv)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_products_cover_their_depth_once_in_whole_steps(b, h, w, c, tail):
    pixels = b * h * w
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, tail, n_sm)
        assert len(plan.splits) == 3
        for nk, (splits, per) in zip(_prods(c, tail), plan.splits):
            if nk is None:
                assert (splits, per) == (1, 0)
                continue
            n, k = nk
            assert (splits, per) == tblock.split_plan(pixels, n, k, n_sm)
            assert splits >= 1 and per % tblock.MM_STEP == 0
            starts = [r * per for r in range(splits)]
            ends = [min(s + per, k) for s in starts]
            # ranges [r * per, min((r + 1) * per, k)): in order, none empty
            assert starts[0] == 0 and ends[-1] == k
            assert all(e > s for s, e in zip(starts, ends))
            assert all(ends[i] == starts[i + 1] for i in range(splits - 1))
            tiles = -(-pixels // tblock.MM_TILE_M) * -(-n // tblock.MM_TILE_N)
            if splits > 1:
                # only where the tiles alone leave the card short
                assert per >= tblock.SPLIT_MIN_STEPS * tblock.MM_STEP
                assert splits * tiles <= tblock.SUM_BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_workspaces_hold_what_the_launches_store(b, h, w, c, tail):
    pixels, width = b * h * w, _width(c, tail)
    sizes = tblock.fwd_workspace_numel(pixels, c, width, tail)
    # t (the t product's output), stats, u (LayerNorm), h (the h product's
    # output, then the gate of a gate pass in rows of gate_ld(h) floats),
    # conv (the depthwise's output)
    hid = width // 2
    stores = ((pixels * c, 2 * pixels, pixels * c, pixels * max(width, -(-hid // 4) * 4),
               pixels * width) if tail else (pixels * c, 2 * pixels, pixels * width))
    assert len(sizes) == len(stores)
    assert all(have >= need for have, need in zip(sizes, stores))
    assert tblock.gate_ld(hid) % 4 == 0 and 0 <= tblock.gate_ld(hid) - hid < 4
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, tail, n_sm)
        needs = [0] + [splits * pixels * nk[0] for nk, (splits, _) in
                       zip(_prods(c, tail), plan.splits) if nk is not None and splits > 1]
        assert plan.sums_numel == max(needs)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_layernorm_blocks_fit_the_card_and_the_pixels(b, h, w, c):
    pixels = b * h * w
    for n_sm in CARDS:
        for tail in (True, False):
            plan = _plan(b, h, w, c, tail, n_sm)
            assert plan.ln_blocks == tblock.ln_plan(pixels, n_sm)[0]
            assert 1 <= plan.ln_blocks <= tblock.LN_BLOCKS_PER_SM * n_sm
            assert plan.ln_blocks <= -(-pixels // tblock.LN_WARPS)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
def test_the_ints_come_in_the_kernels_order(tail):
    plan = _plan(1, 32, 32, 384, tail, 132, vecs=(4, 1, 4), vec_m=2)
    ints = plan.ints()
    assert len(ints) == tblock.FWD_PLAN_INTS == 15
    assert ints[0] == plan.ln_blocks
    assert ints[1:4] == (4, 1, 4)
    assert ints[4:10] == tuple(k for split in plan.splits for k in split)
    if tail:  # the serving latent splits t and out, not h
        assert [s > 1 for s, _ in plan.splits] == [True, False, True]
    else:
        assert plan.splits[0] == plan.splits[2] == (1, 0)
    assert ints[10:14] == plan.dw_conv and plan.dw_conv[0] == 2
    # C = 384 spans six output tiles: the gate is a pass of its own
    assert ints[14] == plan.gate_pass == int(tail)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_gate_is_fused_where_c_fits_one_output_tile(b, h, w, c):
    for n_sm in CARDS:
        assert _plan(b, h, w, c, True, n_sm).gate_pass == int(c > tblock.MM_TILE_N)
        assert _plan(b, h, w, c, False, n_sm).gate_pass == 0


def _rows_fit(base, ld, start, extent, vec, rows=5):
    """Copies of vec floats along `extent` floats from base + start, at
    rows of pitch ld, are each wholly inside the row and 4 vec-byte aligned."""
    return extent % vec == 0 and all(
        (base + 4 * (r * ld + start + k)) % (4 * vec) == 0
        for r in range(rows) for k in range(0, extent, vec))


# (h, pointer of conv, of W_out, of h's buffer) -> the copy widths of the h
# class and of the gate's rows: odd h leaves the c2 half (column h of each
# 2h-wide row of conv) and W_out's rows 4-byte aligned; the gate of a gate
# pass lies in rows padded to gate_ld(h), 16-byte copies at any h
@pytest.mark.parametrize("hid,conv,w_out,hbuf,vec,vec_g", [
    (127, 0, 0, 0, 1, 4), (255, 512, 1024, 0, 1, 4), (1021, 0, 256, 64, 1, 4),
    (510, 0, 0, 0, 2, 4), (510, 0, 8, 8, 2, 2), (510, 4, 0, 4, 1, 1), (128, 0, 0, 0, 4, 4),
    (15, 0, 0, 0, 1, 4), (256, 16, 48, 32, 4, 4)])
def test_the_h_class_copies_fit_both_halves_of_conv_w_out_and_the_gate(hid, conv, w_out,
                                                                        hbuf, vec, vec_g):
    c = 48
    ptrs = {"a": 0, "u": 0, "w_proj": 0, "w_in": 0, "h": hbuf, "conv": conv, "w_out": w_out}
    vec_c, vec_h, got_g, vec_m = tblock.fwd_vecs(c, 2 * hid, True, ptrs)
    assert (vec_h, got_g) == (vec, vec_g)
    assert _rows_fit(ptrs["conv"], 2 * hid, 0, hid, vec_h)    # c1
    assert _rows_fit(ptrs["conv"], 2 * hid, hid, hid, vec_h)  # c2
    assert _rows_fit(ptrs["w_out"], hid, 0, hid, vec_h)
    ld = tblock.gate_ld(hid)  # the gate's copies may run into the zero pad
    assert _rows_fit(ptrs["h"], ld, 0, ld, got_g)
    assert _rows_fit(ptrs["h"], 2 * hid, 0, 2 * hid, vec_m)
    assert vec_c == 4


# the C class and the depthwise width: the widest copy that the width
# divides and every pointer of the class allows
@pytest.mark.parametrize("c,offset", [(48, 0), (48, 4), (48, 8), (6, 0), (5, 0), (384, 12)])
@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
def test_the_c_class_copies_fit_every_operand(c, offset, tail):
    width = _width(c, tail)
    names = (("a", "u", "w_proj", "w_in", "h", "conv", "w_out") if tail
             else ("u", "w_qkv", "h", "out"))
    ptrs = {k: 1024 * i + (offset if k in ("a", "w_qkv") else 0) for i, k in enumerate(names)}
    vec_c, vec_h, vec_g, vec_m = tblock.fwd_vecs(c, width, tail, ptrs)
    for k in (("a", "u", "w_proj", "w_in") if tail else ("u", "w_qkv")):
        assert _rows_fit(ptrs[k], c, 0, c, vec_c)
    assert vec_c == tdw.dwconv_vec(c, offset)
    assert _rows_fit(ptrs["h"], width, 0, width, vec_m)
    assert vec_h == (tdw.dwconv_vec(width // 2, 0, 1024) if tail else 1)
    assert vec_g == (4 if tail else 1)


@pytest.mark.parametrize("sizes", [(5, 300, 0, 129), (1,), (128, 128, 7)])
def test_the_workspaces_of_one_allocation_start_512_bytes_apart_and_fit(sizes):
    buf, addrs = tblock._workspaces("cpu", sizes)
    base = buf.data_ptr()
    offsets = [a - base for a in addrs]
    assert offsets[0] == 0 and all(o % 512 == 0 for o in offsets)
    ends = [o + 4 * k for o, k in zip(offsets, sizes)]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= 4 * buf.numel()


# ------------------------------------------------------------ bf16

def _bf16_rows_fit(base, ld, start, extent, vec, rows=5, itemsize=2):
    """Copies of vec elements along `extent` elements from base + start, at
    rows of pitch ld, wholly inside the row and aligned to the copy's bytes
    (at most 16 for an fp32 output of 8 values, stored 16 bytes at a time)."""
    align = min(16, itemsize * vec)
    return extent % vec == 0 and all(
        (base + itemsize * (r * ld + start + k)) % align == 0
        for r in range(rows) for k in range(0, extent, vec))


# (C, pointer offset of a and W_out) -> the bf16 copy widths of the C class,
# W_out's rows (h), the gate's rows (gate_ld(h, bf16), padded to 8, in a
# workspace of their own) and h's rows in the gated depthwise (two bf16 a
# copy at every h): odd h (127, 255, 1,021) leaves W_out's rows 2-byte
# aligned (one bf16 a load), 2h = 254, 510, 1,020 or 2,042 4-byte aligned
@pytest.mark.parametrize("c,offset,want", [
    (48, 0, (8, 1, 8, 2)), (96, 0, (8, 1, 8, 2)), (192, 0, (8, 2, 8, 2)),
    (384, 0, (8, 1, 8, 2)), (48, 4, (2, 1, 8, 2)), (48, 8, (4, 1, 8, 2)),
    (6, 0, (2, 1, 8, 2))])
def test_the_bf16_tail_copies_fit_every_operand(c, offset, want):
    hid = int(c * 2.66)
    names = ("a", "u", "w_proj", "w_in", "h", "gate", "w_out")
    ptrs = {k: 1024 * i + (offset if k in ("a", "w_out") else 0) for i, k in enumerate(names)}
    vecs = tblock.fwd_vecs(c, 2 * hid, True, ptrs, bf16=True)
    assert vecs == want
    vec_c, vec_h, vec_g, vec_m = vecs
    for k in ("a", "u", "w_proj", "w_in"):
        assert _bf16_rows_fit(ptrs[k], c, 0, c, vec_c)
    assert _bf16_rows_fit(ptrs["w_out"], hid, 0, hid, vec_h)
    ld = tblock.gate_ld(hid, bf16=True)
    assert ld % 8 == 0 and 0 <= ld - hid < 8 and ld == tdw.gate_ld(hid)
    assert _bf16_rows_fit(ptrs["gate"], ld, 0, ld, vec_g)
    # the gated depthwise reads h's rows in copies of two bf16
    assert vec_m == tdw.GATE_VEC and _bf16_rows_fit(ptrs["h"], 2 * hid, 0, 2 * hid, vec_m)


@pytest.mark.parametrize("c,want", [(48, (8, 8)), (96, (8, 8)), (6, (2, 2)), (5, (1, 0))])
def test_the_bf16_head_copies_and_an_odd_width(c, want):
    """3C = 144 takes 16-byte copies; an odd 3C (C = 5) leaves the
    depthwise's bf16 rows 2-byte aligned, below its smallest copy: refused."""
    ptrs = {"u": 0, "w_qkv": 1024, "h": 2048, "out": 4096}
    if want[1] == 0:
        with pytest.raises(ValueError, match="must be even"):
            tblock.fwd_vecs(c, 3 * c, False, ptrs, bf16=True)
        return
    vec_c, vec_h, vec_g, vec_m = tblock.fwd_vecs(c, 3 * c, False, ptrs, bf16=True)
    assert (vec_c, vec_m) == want and (vec_h, vec_g) == (1, 1)
    assert _bf16_rows_fit(ptrs["u"], c, 0, c, vec_c)
    assert _bf16_rows_fit(ptrs["h"], 3 * c, 0, 3 * c, vec_m)
    assert _bf16_rows_fit(ptrs["out"], 3 * c, 0, 3 * c, vec_m)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "head"])
@pytest.mark.parametrize("b,h,w,c", SERVE + ODD)
def test_the_bf16_plan_is_the_fp32_plan_with_its_gate_pass(b, h, w, c, tail):
    """The bf16 kernels take the fp32 plan's splits and LayerNorm blocks
    (the same products, 32 deep a step) and no gate pass: the bf16 tail's
    depthwise takes the gate (kdw.conv_gate_plan's plan); their workspaces
    hold bf16 but for stats, and the tail's hold the gate in place of the
    fp32 conv."""
    pixels, width = b * h * w, _width(c, tail)
    hid = width // 2
    for n_sm in CARDS:
        fp32 = _plan(b, h, w, c, tail, n_sm)
        dw_conv = (tdw.conv_gate_plan(b, h, w, hid, n_sm) if tail else
                   (2, *tdw.dwconv_tile(width, w, 2), tdw.dwconv_rows(b, h, w, width, 2, n_sm, 3)))
        bf16 = tblock.block_fwd_plan(b, h, w, c, width, tail, n_sm, (1, 1, 1), dw_conv, True)
        assert (bf16.ln_blocks, bf16.splits, bf16.sums_numel) == (
            fp32.ln_blocks, fp32.splits, fp32.sums_numel)
        assert bf16.gate_pass == 0 and bf16.ints()[14] == 0
        assert bf16.ints()[10:14] == dw_conv
    sizes = tblock.fwd_workspace_numel(pixels, c, width, tail, bf16=True)
    if not tail:
        # the head's product-depthwise keeps h in the SM: u and stats; its
        # launches of old (C past that kernel's shared memory) add h
        assert len(sizes) == 2
        sizes += (-(-pixels * width // 2),)
    # bf16 t, u, h, the gate (rows of gate_ld(h, bf16)); fp32 stats
    need = ((pixels * c / 2, 2 * pixels, pixels * c / 2, pixels * width / 2,
             pixels * tblock.gate_ld(hid, True) / 2) if tail
            else (pixels * c / 2, 2 * pixels, pixels * width / 2))
    assert len(sizes) == len(need) and all(s >= n for s, n in zip(sizes, need))
