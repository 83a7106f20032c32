"""The plans of bf16 training's backward forms on bf16 tiles, on the CPU:
row 5's tail and head (csrc/block_bwd_bf16.cu, ops/block.py) and row 9's
qkv and GDFN (csrc/fused_dwconv_bf16.cu, ops/fused.py) in bf16.

All four run the fp32 design's plan (block_bwd_plan, fused_bwd_plan) on the
bf16 tensors themselves, with a second plan of their bf16 pieces: the
tail's and the GDFN's copy widths of their bf16 operands (gated_bf16_vecs)
and their depthwise forward into fp32 conv
(gated_bwd_bf16_plan), the qkv's and the head's copy widths and the
depthwise tiles of their rotated forward and their dtaps
(qkv_bwd_bf16_plan). dtaps's sums follow only the columns a block (tc) and
the band (rows) of its tile, so a bf16 dtaps keeps the fp32 design's tc
and rows at whatever copy width its operands allow (ops/dwconv.py retile):
these tests hold that at the sixteen training shapes (the eight block
shapes of chip_smoke.py at 128^2, B = 3, each at the tail's width 2h and
the qkv's 3C) and at odd ones, at every bf16 copy width, with every tile
within the kernel's limits (tc * cv <= 256 threads, cv <= 32 vectors) and
the fp32 design's dtaps workspace; the copy widths of every bf16 operand at
odd h (127, 255, 1,021: W_out's rows 2-byte aligned) and at pointers 2
bytes off; and the workspaces, which hold no fp32 copy of an operand. Also
the bounds chip_smoke.py reports for the bf16 backward forms: each product
counted at the rate for its operands' types; and that no kernel source
includes a widening or rounding pass's header. Pure functions: no card, no
JAX.
"""

from pathlib import Path

import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import fused as tfused

TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 20, 19, 6), (1, 9, 33, 384), (1, 8, 9, 576), (2, 12, 13, 192)]
N_SM = 132


def _hid(c):
    return int(c * 2.66)


def _fp32_taps(b, h, w, width, per_sm=3):
    """The fp32 design's dtaps tile (cv, tc, rows) at its copy width."""
    vec = tdw.dwconv_vec(width)
    cv, tc = tdw.dwconv_tile(width, w, vec)
    rows = tdw.dwconv_rows(b, h, w, width, vec, N_SM, per_sm, tdw.DTAPS_MAX_PIXELS)
    return vec, (cv, tc, rows)


@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
@pytest.mark.parametrize("width", ["2h", "3C"])
def test_a_bf16_dtaps_keeps_the_fp32_designs_columns_and_band(b, h, w, c, width):
    """At every bf16 copy width that divides the width, the retiled dtaps
    keeps tc and rows (so the fp32 sums' order and its workspace), covers
    every channel, and stays within the kernel's thread and vector limits;
    at the fp32 copy width it is the fp32 tile itself."""
    m = 2 * _hid(c) if width == "2h" else 3 * c
    vec32, taps = _fp32_taps(b, h, w, m)
    assert tdw.retile(taps, m, vec32) == (vec32, *taps)
    ws32 = tdw.dtaps_workspace_numel(b, h, w, m, taps[1], taps[2])
    for vec in (8, 4, 2, 1):
        if m % vec:
            continue
        v, cv, tc, rows = tdw.retile(taps, m, vec)
        assert (v, tc, rows) == (vec, taps[1], taps[2])
        assert 1 <= cv <= tdw.DW_VECTORS and tc * cv <= tdw.DW_THREADS
        assert -(-(m // vec) // cv) * cv * vec >= m  # the chunks cover every channel
        assert tdw.dtaps_workspace_numel(b, h, w, m, tc, rows) == ws32


@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_the_qkv_backwards_bf16_plan_comes_in_the_kernels_order(b, h, w, c):
    """qkv_bwd_bf16_plan: the copy width of x and W_in, then the rotated
    depthwise's (vec, cv, tc, rows) and dtaps's at the bf16 copy width, the
    latter on the fp32 design's columns and band."""
    m = 3 * c
    _, taps = _fp32_taps(b, h, w, m)
    rot = (tdw.dwconv_tile(m, w, 8 if m % 8 == 0 else 2)[0], 4, 7)
    for vec_m in (8, 4, 2, 1):
        if m % vec_m:
            continue
        ints = tblock.qkv_bwd_bf16_plan(m, 8, vec_m, rot, taps)
        assert len(ints) == tblock.BWD16_PLAN_INTS == 9
        assert ints[0] == 8
        assert ints[1:5] == tdw.retile(rot, m, vec_m)
        assert ints[5:] == tdw.retile(taps, m, vec_m)
        assert ints[7:] == taps[1:]


@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
def test_the_bf16_backwards_workspaces_hold_no_fp32_copy(b, h, w, c):
    """The tail's: bf16 t, u, h, then stats, conv/dh, dconv, the gate, du and
    dt; the qkv's: bf16 h and fp32 dh. Nothing of the size of an fp32 x, a,
    g or weight beside them."""
    n, hid = b * h * w, _hid(c)
    tail = tblock.bwd_bf16_workspace_numel(n, c, hid)
    assert tail == (-(-n * c // 2), -(-n * c // 2), n * hid, 2 * n, 2 * n * hid, 2 * n * hid,
                    n * hid, n * c, n * c)
    assert tfused.qkv_bwd_bf16_workspace_numel(n, 3 * c) == (-(-n * 3 * c // 2), 3 * n * c)


def _gated_vecs(c, hid, ptrs, c_wide):
    return tblock.gated_bf16_vecs(c, hid, tuple(ptrs[k] for k in c_wide), ptrs["g"],
                                  ptrs["w_out"], ptrs["h"], ptrs["conv"])


# (C, h): the main path's widths, h odd at 127, 255 and 1,021
WIDTHS = [(48, 127), (96, 255), (192, 510), (384, 1021), (6, 15), (576, 1532)]


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "2 bytes off"])
@pytest.mark.parametrize("name", ["a", "u", "w_proj", "w_in", "g", "w_out"])
def test_the_tails_bf16_copies_fit_every_operand(c, hid, offset, name):
    """gated_bf16_vecs for the tail: each copy width divides its width and its pointers'
    alignment in bf16; W_out's rows at odd h take single bf16, the C class
    16-byte copies at C % 8 == 0; one operand 2 bytes off takes single bf16
    in its class and leaves the others as they were."""
    base = 1 << 20
    ptrs = {k: base for k in ("a", "u", "w_proj", "w_in", "g", "w_out", "h", "conv")}
    vec_c, vec_g, vec_h, vec_m = _gated_vecs(c, hid, ptrs, ("a", "u", "w_proj", "w_in"))
    assert vec_c == vec_g == max(v for v in (8, 4, 2, 1) if c % v == 0)
    assert vec_h == max(v for v in (8, 4, 2, 1) if hid % v == 0)
    assert vec_m == max(v for v in (8, 4, 2, 1) if (2 * hid) % v == 0)
    if hid % 2:
        assert vec_h == 1
    ptrs[name] += offset
    got = _gated_vecs(c, hid, ptrs, ("a", "u", "w_proj", "w_in"))
    cls = {"g": 1, "w_out": 2}.get(name, 0)
    for i, (v, was) in enumerate(zip(got, (vec_c, vec_g, vec_h, vec_m))):
        assert v == (1 if offset and i == cls else was)
        width = (c, c, hid, 2 * hid)[i]
        assert width % v == 0


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "2 bytes off"])
def test_the_qkv_backwards_bf16_copies_fit_x_w_in_and_g(c, hid, offset):
    """The qkv backward's bf16 copy widths: x and W_in at C, the depthwise
    pair (h, g) at 3C; a g 2 bytes off takes single bf16, which the
    depthwise kernels' bf16 forms copy by the thread."""
    base = 1 << 20
    m = 3 * c
    assert tdw.bf16_vec(c, base, base) == max(v for v in (8, 4, 2, 1) if c % v == 0)
    vec_m = tdw.bf16_vec(m, base, base + offset)
    assert vec_m == (1 if offset else max(v for v in (8, 4, 2, 1) if m % v == 0))
    _, taps = _fp32_taps(3, 16, 16, m)
    v, cv, tc, rows = tdw.retile(taps, m, vec_m)
    assert tc * cv <= tdw.DW_THREADS and cv <= tdw.DW_VECTORS and m % v == 0


@pytest.mark.parametrize("b,h,w,c", TRAIN)
def test_the_bound_counts_the_tf32_terms_each_policy_runs(b, h, w, c):
    """chip_smoke.bf16_bwd_work counts each product at the least the card
    needs for its operands' types: the recompute and every product of two
    bf16 operands (the tail's and the GDFN's dgate; in ops16 every backward
    product: the tail's 12 C h + 4 C^2 flops a pixel, the qkv's 4 C M, the
    head's 4 C M, the GDFN's 12 h C) at the bf16 rate; in 3xTF32 a product
    of a bf16 and an fp32 operand as two TF32 terms at the TF32 rate."""
    n, m, hid = h * w, 3 * c, _hid(c)
    # per pixel: (recompute, bf16 x bf16, bf16 x fp32) flops
    products = {"block_tail_bwd_bf16": (2 * c * c + 4 * c * hid, 2 * c * hid,
                                        10 * c * hid + 4 * c * c),
                "conv1x1_dw_bwd_bf16": (2 * c * m, 0, 4 * c * m),
                "block_head_bwd_bf16": (2 * c * m, 0, 4 * c * m),
                "gdfn_fused_bwd_bf16": (4 * hid * c, 2 * hid * c, 10 * hid * c)}
    for ops16 in (False, True):
        work = chip_smoke.bf16_bwd_work(b, n, c, ops16)
        assert set(work) == set(products)
        for name, (flops, nbytes) in work.items():
            rec, both, mixed = products[name]
            assert nbytes > 0 and flops["fp32"] > 0
            if ops16:
                assert set(flops) == {"bf16", "fp32"}
                assert flops["bf16"] == b * n * (rec + both + mixed)
            else:
                assert set(flops) == {"bf16", "tf32", "fp32"}
                assert flops["bf16"] == b * n * (rec + both)
                assert flops["tf32"] == 2 * b * n * mixed
        bound, by = chip_smoke.bound_at(*work["block_tail_bwd_bf16"])
        assert bound > 0 and by in ("bytes", "operations")


@pytest.mark.parametrize("heads", [1, 2])
def test_the_mdta_backwards_bound_counts_each_product_at_its_operands_rate(heads):
    """chip_smoke.bf16_gram_yardstick for rows 6-7 on bf16: a product of two
    bf16 operands (row 7's dattn; in ops16, where the fp32 side is rounded,
    every product) at the bf16 rate, one of a bf16 and an fp32 operand (row
    6's d[q|k] against G's cotangent, row 7's dv against attn) as two TF32
    terms."""
    import torch
    b, res, c = 1, 8, 16
    ch, n = c // heads, res * res
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, res, res, 3 * c, generator=gen).bfloat16()
    attn = torch.softmax(torch.randn(b, heads, ch, ch, generator=gen), -1)
    dgram = torch.randn(b, heads, ch, ch, generator=gen)
    g = torch.randn(b, res, res, c, generator=gen).bfloat16()
    yard = chip_smoke.bf16_gram_yardstick(qkv, heads, attn=attn, dgram=dgram, g=g)
    gram, apply = b * n * 4 * c * ch, b * n * 2 * c * ch  # d[q|k]; dv or dattn
    assert yard["mdta_gram_bwd_bf16"][1] == {"tf32": 2 * gram, "fp32": b * n * 4 * c}
    assert yard["mdta_gram_bwd_bf16_b16ops"][1] == {"bf16": gram, "fp32": b * n * 4 * c}
    assert yard["attn_apply_bwd_bf16"][1] == {"tf32": 2 * apply, "bf16": apply}
    assert yard["attn_apply_bwd_bf16_b16ops"][1] == {"bf16": 2 * apply}


def _fp32_plan(form, b, h, w, c):
    """The fp32 design's plan of the head (block_bwd_plan) or the GDFN
    (fused_bwd_plan) at its fp32 copy widths, and its depthwise width."""
    hid = _hid(c)
    m = 3 * c if form == "head" else 2 * hid
    vec_m, taps = _fp32_taps(b, h, w, m)
    conv = (vec_m, *tdw.dwconv_tile(m, w, vec_m), 5)
    if form == "head":
        plan = tblock.block_bwd_plan(b, h, w, c, m, False, N_SM,
                                     (tdw.dwconv_vec(c), 1, vec_m), conv, (vec_m, *taps))
    else:
        plan = tfused.fused_bwd_plan(b, h, w, c, m, True, N_SM,
                                     (tdw.dwconv_vec(c), tdw.dwconv_vec(hid), vec_m), conv,
                                     (vec_m, *taps))
    return plan, m


@pytest.mark.parametrize("b,h,w,c", TRAIN + ODD)
@pytest.mark.parametrize("form", ["head", "GDFN"])
def test_the_head_and_gdfn_bf16_plans_come_in_the_kernels_order(b, h, w, c, form):
    """The head's second plan is qkv_bwd_bf16_plan's nine ints on its fp32
    plan's dtaps tile (tc and rows kept at every bf16 copy width); the
    GDFN's is gated_bwd_bf16_plan's seven (bf16 a copy of x and W_in, of g,
    of W_out's rows, then the bf16 depthwise forward's (vec, cv, tc, rows)),
    its rotated depthwise and dtaps read as the fp32 plan's own tiles, which
    read the fp32 dconv at the fp32 copy width."""
    plan, m = _fp32_plan(form, b, h, w, c)
    ints = plan.ints()
    taps = plan.dw_taps
    if form == "head":
        assert len(ints) == tblock.PLAN_INTS and plan.dw_conv == (0, 0, 0, 0)
        for vec_m in (8, 4, 2, 1):
            if m % vec_m:
                continue
            got = tblock.qkv_bwd_bf16_plan(m, 8, vec_m, plan.dw_rot[1:], taps[1:])
            assert len(got) == tblock.BWD16_PLAN_INTS
            assert got[:2] == (8, vec_m) and got[5] == vec_m
            assert got[7:] == taps[2:]
        return
    assert len(ints) == tfused.BWD_PLAN_INTS
    assert ints[-8:] == (*plan.dw_rot, *plan.dw_taps) and taps[0] == tdw.dwconv_vec(m)
    assert tdw.retile(taps[1:], m, taps[0]) == taps
    dw16 = (8 if m % 8 == 0 else 2, 3, 4, 5)
    got = tblock.gated_bwd_bf16_plan(8, 4, 1, dw16)
    assert got == (8, 4, 1, *dw16) and len(got) == tblock.GATED16_PLAN_INTS


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "2 bytes off"])
@pytest.mark.parametrize("name", ["x", "w_in", "g", "w_out"])
def test_the_gdfn_backwards_bf16_copies_fit_every_operand(c, hid, offset, name):
    """gated_bf16_vecs for the GDFN: x and W_in share the C class, g has its own,
    W_out's rows at odd h take single bf16, the depthwise forward of h into
    fp32 conv at 2h; one operand 2 bytes off takes single bf16 in its class
    and leaves the others as they were, each width a divisor of its class's."""
    base = 1 << 20
    ptrs = {k: base for k in ("x", "w_in", "g", "w_out", "h", "conv")}
    was = _gated_vecs(c, hid, ptrs, ("x", "w_in"))
    assert was[0] == was[1] == max(v for v in (8, 4, 2, 1) if c % v == 0)
    assert was[2] == max(v for v in (8, 4, 2, 1) if hid % v == 0)
    assert was[3] == max(v for v in (8, 4, 2, 1) if (2 * hid) % v == 0) >= 2
    ptrs[name] += offset
    got = _gated_vecs(c, hid, ptrs, ("x", "w_in"))
    cls = {"g": 1, "w_out": 2}.get(name, 0)
    for i, (v, w) in enumerate(zip(got, was)):
        assert v == (1 if offset and i == cls else w)
        assert (c, c, hid, 2 * hid)[i] % v == 0


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "2 bytes off"])
@pytest.mark.parametrize("name", ["u", "w_qkv", "g"])
def test_the_heads_bf16_copies_fit_u_w_qkv_and_g(c, hid, offset, name):
    """The head backward's bf16 copy widths: u and W_qkv at C, the depthwise
    pair (h, g) at 3C; one 2 bytes off takes single bf16 in its class, which
    the depthwise kernels' bf16 forms copy by the thread, on dtaps's fp32
    columns and band."""
    base = 1 << 20
    m = 3 * c
    ptrs = {k: base for k in ("u", "w_qkv", "h", "g")}
    ptrs[name] += offset
    vec_c = tdw.bf16_vec(c, ptrs["u"], ptrs["w_qkv"])
    vec_m = tdw.bf16_vec(m, ptrs["h"], ptrs["g"])
    assert vec_c == (1 if offset and name != "g" else max(v for v in (8, 4, 2, 1) if c % v == 0))
    assert vec_m == (1 if offset and name == "g" else max(v for v in (8, 4, 2, 1) if m % v == 0))
    vec32, taps = _fp32_taps(3, 16, 16, m)
    ints = tblock.qkv_bwd_bf16_plan(m, vec_c, vec_m, taps, taps)
    v, cv, tc, rows = ints[5:]
    assert (v, tc, rows) == (vec_m, *taps[1:]) and m % v == 0
    assert tc * cv <= tdw.DW_THREADS and cv <= tdw.DW_VECTORS


def test_no_kernel_source_includes_a_widening_pass():
    """No source under rcot_torch/csrc/ includes cast.cuh, the widening and
    rounding passes every bf16 backward form has dropped, and the header is
    gone: each form reads its bf16 tensors as they are."""
    csrc = Path(tblock.__file__).resolve().parents[1] / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert len(sources) > 20
    assert not (csrc / "cast.cuh").exists()
    for f in sources:
        assert '#include "cast.cuh"' not in f.read_text(), f.name
