"""The plan of the product-depthwise (csrc/pw_dw.cu, rcot_torch/ops/dwconv.py
pw_dw_plan), on the CPU.

The bf16 forwards of row 1's head (csrc/block_fwd_bf16.cu, after its
LayerNorm) and row 8's qkv (csrc/fused_dwconv_bf16.cu) take their 1x1
product inside the depthwise's band: one launch reads u (the qkv's x) and
writes qkv, and h never reaches device memory. These tests hold its plan at
every serving and training block shape of chip_smoke.py and at odd ones
(C = 2-384, the 250 x 321 image, the latent, ragged tiles, fewer pixels than
a tile; C past 512 and up to the widest it takes), on cards of 132, 1, 7 and
200 SMs: every output pixel and channel stored once; the halo rows and
columns outside the image zero, which a float64 emulation of the block's
walk holds against the plain head; a staged row one 16-row mma tile; the W
chunk, the ring, the h rows and the taps within what a block may take; the
product's K ranges those of the design it replaces, and the shapes where K
splits; the Python mirror's constants those of the source; and the bf16
head's workspaces, which hold no h.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw

CARDS = (132, 1, 7, 200)
SERVE = [(b, res, res, c) for _, res, c, _ in chip_smoke.MAIN_SHAPES for b in (1, 2)]
TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 250, 321, 48), (2, 9, 13, 25), (2, 17, 19, 26), (1, 20, 19, 6), (2, 12, 13, 192),
       (1, 9, 33, 384), (1, 12, 12, 576), (1, 8, 9, 1024), (3, 11, 29, 48), (1, 1, 1, 8),
       (2, 7, 5, 2), (8, 256, 256, 48)]
SHAPES = SERVE + TRAIN + ODD
CSRC = Path(__file__).resolve().parents[1] / "rcot_torch" / "csrc"


def _cdiv(a, b):
    return -(-a // b)


def _width(c):
    """The qkv width 3C, made even where C is odd (the bf16 depthwise's
    copies move two bf16 at least, so an odd M is refused)."""
    return 3 * c + (3 * c) % 2


def _plan(b, h, w, c, n_sm):
    """The wrappers' plan on 16-byte aligned tensors (bf16_vec at address 0)."""
    m = _width(c)
    return tdw.pw_dw_plan(b, h, w, c, m, n_sm, tdw.bf16_vec(c, 0), tdw.bf16_vec(m, 0),
                          tblock.split_plan(b * h * w, m, c, n_sm))


def _blocks(b, h, w, m, plan):
    """(image, y0, n_out, x0, c0) of every block of the launch: the grid of
    csrc/pw_dw.cu (column tile, channel chunk, image x band)."""
    cw, rows = plan[2], plan[3]
    for z in range(b * _cdiv(h, rows)):
        img, band = divmod(z, _cdiv(h, rows))
        y0 = band * rows
        for x0 in range(0, _cdiv(w, tdw.PW_COLS) * tdw.PW_COLS, tdw.PW_COLS):
            for c0 in range(0, _cdiv(m, cw) * cw, cw):
                yield img, y0, min(rows, h - y0), x0, c0


def _stored(x0, c0, w, m, plan):
    """{(column, channel)} a block's threads store in each output row:
    thread (j, v) column x0 + j of j < PW_COLS, channels c0 + PW_VEC v..,
    active where both lie in the image (the kernel's `active`); four a
    store at vec_out 4, else pairs, the second where it lies below M."""
    vec_out, cw = plan[1], plan[2]
    out = set()
    for j in range(tdw.PW_COLS):
        for v in range(cw // tdw.PW_VEC):
            c = c0 + tdw.PW_VEC * v
            if x0 + j >= w or c >= m:
                continue
            chans = range(c, c + 4) if vec_out >= 4 or c + 2 < m else range(c, c + 2)
            out.update((x0 + j, ch) for ch in chans)
    return out


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_plan_stores_every_output_pixel_and_channel_once(b, h, w, c):
    """Column tiles of PW_COLS, chunks of cw channels and bands of rows
    cover the image and M once: each block stores rows y0.. of its band,
    the columns and channels of its threads inside the image; a chunk is
    a multiple of 8 up to PW_MAX_CHUNK, the fewest chunks, then the
    narrowest, below C = 384; the band comes from band_rows at the blocks
    an SM that the kernel's shared memory and launch bound allow."""
    m = _width(c)
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, n_sm)
        vec_c, vec_out, cw, rows, stages, group, _, _ = plan
        assert len(plan) == tdw.PW_PLAN_INTS and vec_out in (2, 4) and m % vec_out == 0
        assert c % vec_c == 0 and stages in (2, 3)
        assert group == tdw.pw_dw_group(c) == (4 if c <= 128 else 2 if c <= 384 else 1)
        assert cw % 8 == 0 and 8 <= cw <= tdw.PW_MAX_CHUNK
        chunks = _cdiv(m, cw)
        assert chunks == _cdiv(m, tdw.PW_MAX_CHUNK) or c >= 384
        assert chunks * cw >= m > chunks * (cw - 8)
        per_sm = tdw.pw_dw_per_sm(c, cw, stages)
        assert 1 <= per_sm <= tdw.PW_BLOCKS_PER_SM
        per_band = b * _cdiv(w, tdw.PW_COLS) * chunks
        assert rows == tdw.band_rows(h, per_band, tdw.PW_COLS, n_sm, per_sm)
        assert 1 <= rows <= h
    # every (row, column, channel) of one image once, at 132 SMs
    plan = _plan(b, h, w, c, 132)
    count = np.zeros((h, w, m), np.int16)
    stored = {}
    for img, y0, n_out, x0, c0 in _blocks(1, h, w, m, plan):
        cols = stored.setdefault((x0, c0), sorted(_stored(x0, c0, w, m, plan)))
        xs, cs = (np.array(t) for t in zip(*cols))
        count[y0:y0 + n_out, xs, cs] += 1
    assert (count == 1).all()


def _ln(x, ln_w, ln_b):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + 1e-5) * ln_w + (0 if ln_b is None else ln_b)


def _walk(x, ln_w, ln_b, wq, taps, plan):
    """qkv as the kernel's blocks make it, in float64 with no roundings:
    each block stages input rows y0 - 1.. of its band, PW_PIXELS columns
    from x0 - 1, takes h of the pixels inside the image (p_lo <= p < p_hi)
    and zeros at the others and at rows outside the image, and runs the
    stencil on those rows alone; (qkv, how often each entry was stored)."""
    b, h, w, c = x.shape
    m = wq.shape[0]
    cw = plan[2]
    out = np.zeros((b, h, w, m))
    count = np.zeros((b, h, w, m), np.int16)
    for img, y0, n_out, x0, c0 in _blocks(b, h, w, m, plan):
        p_lo, p_hi = max(0, 1 - x0), min(tdw.PW_PIXELS, w - x0 + 1)
        wch = np.zeros((cw, c))
        wch[:max(0, min(cw, m - c0))] = wq[c0:c0 + cw]
        band = np.zeros((n_out + 2, tdw.PW_PIXELS, cw))
        for r in range(n_out + 2):
            y = y0 - 1 + r
            if 0 <= y < h and p_lo < p_hi:
                u = x[img, y, x0 - 1 + p_lo:x0 - 1 + p_hi]
                if ln_w is not None:
                    u = _ln(u, ln_w, ln_b)
                band[r, p_lo:p_hi] = u @ wch.T
        tch = np.zeros((cw, 3, 3))
        tch[:max(0, min(cw, m - c0))] = taps[c0:c0 + cw]
        for o in range(n_out):
            conv = sum(tch[:, i, jj] * band[o + i, jj:jj + tdw.PW_COLS]
                       for i in range(3) for jj in range(3))
            for col, ch in _stored(x0, c0, w, m, plan):
                out[img, y0 + o, col, ch] = conv[col - x0, ch - c0]
                count[img, y0 + o, col, ch] += 1
    return out, count


@pytest.mark.parametrize("ln", [True, False], ids=["head", "qkv"])
@pytest.mark.parametrize("b,h,w,c", [(2, 9, 13, 6), (1, 20, 19, 8), (2, 7, 5, 2), (1, 1, 1, 8),
                                     (1, 17, 30, 26), (1, 5, 16, 25)])
def test_the_halo_outside_the_image_is_zero_in_the_blocks_walk(b, h, w, c, ln):
    """The kernel's walk (its tiles, bands, halo rule and stores), emulated
    in float64 with no roundings, equals the plain head (qkv) with its zero
    padding of h, not of x: rows and columns outside the image are zero in
    h (LN(0) = ln_b would not be), at every card's band; each entry once."""
    rng = np.random.default_rng(24)
    m = _width(c)
    x = rng.standard_normal((b, h, w, c))
    ln_w, ln_b = 1 + 0.2 * rng.standard_normal(c), 0.5 + 0.1 * rng.standard_normal(c)
    wq, taps = rng.standard_normal((m, c)), rng.standard_normal((m, 3, 3))
    hh = (_ln(x, ln_w, ln_b) if ln else x) @ wq.T
    pad = np.pad(hh, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(taps[:, i, j] * pad[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    for n_sm in CARDS:
        plan = _plan(b, h, w, c, n_sm)
        got, count = _walk(x, ln_w if ln else None, ln_b if ln else None, wq, taps, plan)
        assert (count == 1).all()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_a_staged_row_is_one_16_row_mma_tile():
    """PW_COLS + 2 pixels (the halo column on each side) fill one m16 tile;
    a chunk's stencil threads, PW_VEC channels of one column each, fit a
    block; the widest chunk is a whole number of 8-channel n tiles."""
    assert tdw.PW_PIXELS == tdw.PW_COLS + 2 and tdw.PW_PIXELS % 16 == 0
    assert tdw.PW_COLS * tdw.PW_MAX_CHUNK // tdw.PW_VEC <= tdw.DW_THREADS
    assert tdw.PW_COLS * (tdw.PW_MAX_CHUNK + 8) // tdw.PW_VEC > tdw.DW_THREADS
    assert tdw.PW_MAX_CHUNK % 8 == 0 and tdw.PW_STEP == tblock.MM_STEP


@pytest.mark.parametrize("c", [2, 6, 25, 26, 48, 96, 128, 192, 256, 384, 512, 513, 576, 768,
                               1024, 1536, 2048, 2880])
def test_the_w_chunk_and_the_rings_fit_a_block(c):
    """pw_dw_smem: a ring of `stages` steps of pw_dw_group(C) rows of
    PW_PIXELS pixels, C in whole K steps and 8 more a pixel, then the W
    chunk (cw rows the same), two steps' h rows (PW_PIXELS by
    pw_dw_ldh(cw)), all bf16, then 9 fp32 taps a channel; within what a
    block may take (ops/block.py SMEM_BYTES). The plan's chunk and ring read
    x the fewest times for each block an SM holds: three stages and the
    fewest chunks of up to 72 channels with two blocks an SM up to C = 256,
    64 channels and a ring of two at 384; no other chunk pw_dw_chunk gives
    or ring does better. Every part is 16-byte aligned, and both pitches
    spread a fragment's eight rows over 32 banks."""
    m = 3 * c
    cw, stages = tdw.pw_dw_fit(c, m)
    ldk, ldh = tdw.pw_dw_ldk(c), tdw.pw_dw_ldh(cw)
    assert ldk == _cdiv(c, 32) * 32 + 8 and ldk >= c + 8
    assert (ldk // 2) % 8 == 4 and (2 * ldk) % 16 == 0
    assert ldh >= cw and ldh % 16 == 8 and (2 * ldh) % 16 == 0
    r = tdw.pw_dw_group(c)
    parts = (2 * stages * r * tdw.PW_PIXELS * ldk, 2 * cw * ldk,
             2 * 2 * r * tdw.PW_PIXELS * ldh, 4 * 9 * cw)
    assert all(p % 16 == 0 for p in parts)
    smem = tdw.pw_dw_smem(c, cw, stages)
    assert smem == sum(parts) <= tblock.SMEM_BYTES
    per_sm = tdw.pw_dw_per_sm(c, cw, stages)
    assert per_sm >= 1
    if c <= 256:
        assert (cw, stages, per_sm) == (tdw.pw_dw_chunk(m), tdw.PW_STAGES, tdw.PW_BLOCKS_PER_SM)
    if c == 384:
        assert (cw, stages, per_sm) == (64, 2, tdw.PW_BLOCKS_PER_SM)
    others = [(w, s) for w in {tdw.pw_dw_chunk(m, most) for most in range(72, 0, -8)}
              for s in (2, 3) if tdw.pw_dw_per_sm(c, w, s) >= 1]
    assert all(_cdiv(m, cw) / per_sm <= _cdiv(m, w) / tdw.pw_dw_per_sm(c, w, s)
               for w, s in others)


def test_past_the_widest_c_there_is_no_plan():
    """C above pw_dw_max_channels fits no chunk and no ring: pw_dw_plan
    returns None, and the head and the qkv take their launches of old."""
    top = tdw.pw_dw_max_channels()
    assert top == 2880 and tdw.pw_dw_fit(top, 3 * top) is not None
    assert tdw.pw_dw_fit(top + 32, 3 * (top + 32)) is None
    assert tdw.pw_dw_plan(1, 4, 4, top + 32, 3 * (top + 32), 132, 8, 4, (1, 0)) is None
    assert top < tblock.LN_MAX_CHANNELS


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_k_ranges_are_the_products_and_where_k_splits(b, h, w, c):
    """The plan's (K ranges, depth a range) are split_plan's for the product
    it replaces (pixels x M over depth C), so each h sums in mm.cuh's order:
    one range of all C, or ranges of whole 32-deep steps that cover C. At
    132 SMs K splits only at the training latent's 16^2 x 384 by B = 3
    (two ranges of 192) among the main path's shapes; of the odd ones, in
    three ranges at 9 x 33 by 384, four at 12^2 by 576 and five at 8 x 9
    by 1,024 (the fixed-order sum's groups of two and four)."""
    m = _width(c)
    for n_sm in CARDS:
        parts, per = tblock.split_plan(b * h * w, m, c, n_sm)
        plan = _plan(b, h, w, c, n_sm)
        assert plan[6] == parts
        if parts == 1:
            assert plan[7] == c
            continue
        assert plan[7] == per and per % tdw.PW_STEP == 0
        assert (parts - 1) * per < c <= parts * per
    parts = _plan(b, h, w, c, 132)[6]
    main = (b, h, w, c) in SERVE + TRAIN
    if main:
        assert (parts > 1) == ((b, h, w, c) == (3, 16, 16, 384))
    want = {(3, 16, 16, 384): (2, 192), (1, 9, 33, 384): (3, 128), (1, 12, 12, 576): (4, 160),
            (1, 8, 9, 1024): (5, 224)}
    if (b, h, w, c) in want:
        assert _plan(b, h, w, c, 132)[6:] == want[(b, h, w, c)]


def _source(name):
    return (CSRC / name).read_text()


def test_the_python_mirror_holds_the_sources_constants():
    """The plan's copies of the kernel's columns, stencil vector, launch
    bound, threads, K step, pitches and plan layout are csrc/pw_dw.cu's,
    pw_dw.cuh's and mm.cuh's; the split ranges are added in mm.cuh's
    sum_parts order (the same rule for the warps a group)."""
    src, hdr, mm = _source("pw_dw.cu"), _source("pw_dw.cuh"), _source("mm.cuh")

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const(src, "kPwThreads") == tdw.DW_THREADS
    assert const(src, "kPwCols") == tdw.PW_COLS
    assert const(src, "kPwVec") == tdw.PW_VEC
    assert const(src, "kPwBlocksPerSm") == tdw.PW_BLOCKS_PER_SM
    assert "kPwMaxChunk = kPwThreads / kPwCols * kPwVec / 8 * 8" in src
    assert re.search(r"BM = \d+, BN = \d+, BK = (\d+)", mm).group(1) == str(tdw.PW_STEP)
    assert "return (C + BK - 1) / BK * BK + 8;" in src
    assert "return cw + (24 - cw % 16) % 16;" in src
    names = re.search(r"enum Plan \{([^}]*)\}", hdr).group(1).replace(" ", "").split(",")
    assert names[-1] == "kPlanInts" and len(names) - 1 == tdw.PW_PLAN_INTS
    assert names[:-1] == ["kVecC", "kVecOut", "kChunk", "kRows", "kStages", "kGroup", "kParts",
                          "kKPer"]
    assert "return C <= 128 ? 4 : C <= 384 ? 2 : 1;" in src
    assert tdw.PW_GROUPS == ((128, 4), (384, 2))
    assert "while (W < kReduceThreads / 32 && 2 * W <= parts) W *= 2;" in mm
    assert "while (nw < kReduceThreads / 32 && 2 * nw <= parts) nw *= 2;" in src


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_bf16_heads_workspaces_hold_no_h(b, h, w, c):
    """The bf16 head's product-depthwise keeps h in the SM: its forward
    takes u (N x C bf16) and the LayerNorm's stats (2N fp32), where the
    launches it replaced took h (N x 3C bf16) too; the launches that C past
    pw_dw_max_channels takes add h. The tail's are unchanged and the fp32
    head keeps its three."""
    n, m = b * h * w, 3 * c
    assert tblock.fwd_workspace_numel(n, c, m, False, bf16=True) == (_cdiv(n * c, 2), 2 * n)
    hid = int(2.66 * c)
    assert len(tblock.fwd_workspace_numel(n, c, 2 * hid, True, bf16=True)) == 5
    assert tblock.fwd_workspace_numel(n, c, m, False) == (n * c, 2 * n, n * m)
