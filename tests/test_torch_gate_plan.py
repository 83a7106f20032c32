"""The plan of the gated depthwise (csrc/dwconv.cu dwconv3x3_gate_kernel,
rcot_torch/ops/dwconv.py conv_gate_plan), on the CPU.

The bf16 forwards of row 2's tail (csrc/block_fwd_bf16.cu) and row 8's GDFN
(csrc/fused_dwconv_bf16.cu) take their gate gelu(c1) c2 in their depthwise:
one launch reads the bf16 h (N, 2h) and writes the bf16 gate in rows of
gate_ld(h) = h rounded up to 8, with zeros past h, and the fp32 conv never
leaves the SM. These tests hold its plan at every serving and training
block shape of chip_smoke.py and at odd ones (h = 15, 127, 255, 510, 1,021
and 1,532; ragged tiles, fewer pixels than a tile), on cards of 132, 1, 7
and 200 SMs: every pixel and every channel of the padded gate rows once;
the copies of both halves of h 4-byte aligned and inside the tensor, c2's
at odd h staged from the 4-byte column before it, every channel a thread
reads inside a copy that the kernel makes; a ring stage's layout, each
piece once and every read inside its column's piece; the shared memory
and the blocks an SM, and the Python mirror's constants those of the
source; the bf16 forwards' workspaces, which hold the gate and no fp32
conv; and their plans, which hold no gate pass.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import fused as tfused

CARDS = (132, 1, 7, 200)
SERVE = [(b, res, res, c) for _, res, c, _ in chip_smoke.MAIN_SHAPES for b in (1, 2)]
TRAIN = [(chip_smoke.TRAIN_B, res, res, c) for _, res, c, _ in chip_smoke.TRAIN_SHAPES]
ODD = [(1, 20, 19, 6), (2, 12, 13, 192), (1, 9, 33, 384), (1, 8, 9, 576), (1, 250, 321, 48),
       (3, 11, 29, 48), (1, 1, 1, 5), (2, 7, 5, 1), (8, 256, 256, 48)]
SHAPES = SERVE + TRAIN + ODD
# the gate widths h = int(2.66 C) of those shapes and of the main path's
HIDS = sorted({int(2.66 * c) for *_, c in SHAPES} | {127, 255, 510, 1021})
SOURCE = Path(__file__).resolve().parents[1] / "rcot_torch" / "csrc" / "dwconv.cu"


def _hid(c):
    return int(c * 2.66)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_gate_plan_covers_every_pixel_and_gate_channel_once(b, h, w, c):
    """(vec, cv, tc, rows): two bf16 a vector, at most 32 vectors and 256
    threads a block, chunks of cv vectors over the gate's padded row with
    none empty, column tiles (tc threads of two columns each) and bands
    that cover the image once, and the
    band from dwconv_rows at the blocks an SM that the kernel's shared
    memory and launch bound allow."""
    hid = _hid(c)
    ld = tdw.gate_ld(hid)
    for n_sm in CARDS:
        vec, cv, tc, rows = tdw.conv_gate_plan(b, h, w, hid, n_sm)
        assert vec == tdw.GATE_VEC == 2
        assert 1 <= cv <= tdw.DW_VECTORS and 1 <= tc and tc * cv <= tdw.DW_THREADS
        groups = _cdiv(w, tdw.GATE_COLS)  # a thread's columns
        assert (cv, tc) == tdw.dwconv_tile(ld, groups, vec)
        chunks = _cdiv(ld // vec, cv)
        assert chunks * cv * vec >= ld > (chunks - 1) * cv * vec
        span = tdw.GATE_COLS * tc  # a block's columns
        assert _cdiv(w, span) * span >= w > (_cdiv(w, span) - 1) * span
        assert 1 <= rows <= h and _cdiv(h, rows) * rows >= h
        per_sm = tdw.conv_gate_per_sm(cv, tc)
        assert 1 <= per_sm <= tdw.GATE_BLOCKS_PER_SM
        assert rows == tdw.dwconv_rows(b, h, groups, ld, vec, n_sm, per_sm)


@pytest.mark.parametrize("hid", HIDS)
def test_the_gate_rows_are_padded_to_16_bytes_and_stored_once(hid):
    """gate_ld(h) is h rounded up to 8 bf16 (16 bytes), the product's
    rows' pitch (ops/block.py gate_ld in bf16); the kernel's threads, one
    vector of two channels each, store every column of a padded row once
    (those past h as zeros), 4-byte aligned, and nothing past the row."""
    ld = tdw.gate_ld(hid)
    assert ld % 8 == 0 and hid <= ld < hid + 8 and ld == tblock.gate_ld(hid, True)
    vec, cv, _, _ = tdw.conv_gate_plan(1, 16, 16, hid, 132)
    stored = []
    for c0 in range(0, _cdiv(ld // vec, cv) * cv * vec, cv * vec):
        for v in range(cv):
            col = c0 + v * vec
            if col < ld:  # the kernel's `active`
                assert (2 * col) % 4 == 0 and col + vec <= ld
                stored += range(col, col + vec)
    assert sorted(stored) == list(range(ld))


def _staged_c2(hid, cv, c0):
    """The kernel's c2 pieces of one staged column for the chunk at c0, as
    dwconv3x3_gate_kernel makes them: {index in the staged row: (first
    column of h's row, elements, copied)}; the shift stages from d = h % 2
    columns before c2 and one piece more."""
    vec = tdw.GATE_VEC
    d, cw = hid % vec, cv * vec
    pieces = {v * vec: (hid - d + c0 + v * vec, vec, c0 + v * vec < hid) for v in range(cv)}
    if d:
        pieces[cw] = (hid - d + c0 + cw, vec, c0 + cw + vec <= hid + d)
    return pieces


@pytest.mark.parametrize("hid", HIDS)
def test_both_halves_copy_4_bytes_inside_the_tensor_and_cover_what_is_read(hid):
    """h's rows are 2h bf16 (4h bytes) apart. c1's copies start at even
    columns below h: 4-byte aligned, inside the pixel's row. c2 starts at
    column h: at even h its copies are c1's moved by h; at odd h the kernel
    stages it from column h - 1 (4-byte aligned) in copies of two, one more
    a staged column. Every copy that the kernel makes lies inside the
    pixel's row (so never past the tensor), and each c2 element that a
    thread of channel < h reads (d + 2v + e into the staged row) is a
    copy's element at column h + c of h's row."""
    vec = tdw.GATE_VEC
    ld = tdw.gate_ld(hid)
    _, cv, _, _ = tdw.conv_gate_plan(1, 16, 16, hid, 132)
    d, cw = hid % vec, cv * vec
    for c0 in range(0, _cdiv(ld // vec, cv) * cw, cw):
        for v in range(cv):
            gc = c0 + v * vec
            if gc < hid:  # c1's copy
                assert (2 * gc) % 4 == 0 and gc + vec <= 2 * hid
        pieces = _staged_c2(hid, cv, c0)
        for at, (col, n, copied) in pieces.items():
            if copied:
                assert 0 <= col and col + n <= 2 * hid
                assert (2 * col) % 4 == 0 and (4 * hid) % 4 == 0
        for v in range(cv):
            for e in range(vec):
                ch = c0 + v * vec + e
                if ch >= hid:
                    continue
                pos = d + v * vec + e
                at = max(k for k in pieces if k <= pos)
                col, n, copied = pieces[at]
                assert copied and pos - at < n and col + pos - at == hid + ch


@pytest.mark.parametrize("hid", HIDS)
def test_a_ring_stage_holds_every_staged_piece_once_and_every_read(hid):
    """A ring stage (csrc/dwconv.cu gate_slot, 2 tc + 2 staged columns) holds
    c1's pieces of every column (cw bf16 a column) and then c2's (ld2 = cw
    + 2 a column, the last piece the shift's): no two pieces share a bf16,
    none lies past the stage, and every bf16 that thread (j, v) reads, c1's
    at its four input columns 2j.. and c2's d past them, lies in a piece
    of that column and half, so a read never meets another column's copy."""
    vec, d = tdw.GATE_VEC, hid % tdw.GATE_VEC
    for w in (16, 321):
        _, cv, tc, _ = tdw.conv_gate_plan(1, 16, w, hid, 132)
        cw, cols = cv * vec, tdw.GATE_COLS * tc + 2
        ld2, c2_at = cw + vec, cols * cw
        slot = cols * (2 * cw + vec)
        assert 2 * tdw.GATE_STAGES * slot <= tdw.conv_gate_smem(cv, tc)
        owner = {}  # bf16 of the stage -> (half, column)
        for i in range(cols * cv):  # piece i: column i // cv, vector i % cv
            col = i // cv
            for at, half in ((i * vec, 1), (c2_at + i * vec + col * vec, 2)):
                for e in range(vec):
                    assert at + e not in owner
                    owner[at + e] = (half, col)
        if d:
            for col in range(cols):
                for e in range(vec):
                    assert c2_at + col * ld2 + cw + e not in owner
                    owner[c2_at + col * ld2 + cw + e] = (2, col)
        assert max(owner) < slot and min(owner) >= 0
        for j in range(tc):
            for v in range(cv):
                for q in range(4):
                    col = tdw.GATE_COLS * j + q
                    for e in range(vec):
                        assert owner[(col * cv + v) * vec + e] == (1, col)
                        assert owner[c2_at + col * ld2 + v * vec + d + e] == (2, col)


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_gate_kernels_shared_memory_and_blocks_an_sm(b, h, w, c):
    """conv_gate_smem: a ring of GATE_STAGES stages of 2 tc + 2 columns of
    c1's chunk (cw bf16) and of c2's (cw + 2), rounded to 16 bytes, then
    both halves' 9 taps a channel in fp32; under the 48 KB a block takes
    without opting in, so that two blocks an SM (the launch bound) fit."""
    hid = _hid(c)
    for n_sm in CARDS:
        _, cv, tc, _ = tdw.conv_gate_plan(b, h, w, hid, n_sm)
        cw = 2 * cv
        ring = 2 * tdw.GATE_STAGES * (tdw.GATE_COLS * tc + 2) * (cw + cw + 2)
        smem = tdw.conv_gate_smem(cv, tc)
        assert smem == _cdiv(ring, 16) * 16 + 4 * 18 * cw
        assert smem <= 48 * 1024
        assert tdw.conv_gate_per_sm(cv, tc) == tdw.GATE_BLOCKS_PER_SM == 2


def test_the_python_mirror_holds_the_sources_constants():
    """The plan's copies of the kernel's vector, ring depth and launch bound
    are csrc/dwconv.cu's."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kGateVec") == tdw.GATE_VEC
    assert const("kGateCols") == tdw.GATE_COLS
    assert const("kStages") == tdw.GATE_STAGES
    assert const("kGateBlocksPerSm") == tdw.GATE_BLOCKS_PER_SM


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_the_bf16_forwards_workspaces_hold_the_gate_and_no_fp32_conv(b, h, w, c):
    """The bf16 tail's workspaces: bf16 t, u, h, the gate (rows of
    gate_ld(h)) and fp32 stats; the GDFN's: bf16 h and the gate. Neither
    holds anything of an fp32 conv's size (N x 2h floats), and both take
    N (2h + gate_ld(h)) bf16 where the parent design took N max(2h, gate_ld)
    bf16 and N 2h floats of conv."""
    n, hid = b * h * w, _hid(c)
    ld = tdw.gate_ld(hid)
    tail = tblock.fwd_workspace_numel(n, c, 2 * hid, True, bf16=True)
    assert tail == (_cdiv(n * c, 2), 2 * n, _cdiv(n * c, 2), _cdiv(n * 2 * hid, 2),
                    _cdiv(n * ld, 2))
    gdfn = tfused.gdfn_fwd_bf16_workspace_numel(n, hid)
    assert gdfn == (n * hid, _cdiv(n * ld, 2))
    conv = n * 2 * hid  # floats of the fp32 conv the parent design stored
    parent_h = _cdiv(n * max(2 * hid, ld), 2)  # its h, which then took the gate
    assert sum(gdfn) == _cdiv(n * 2 * hid, 2) + _cdiv(n * ld, 2) < parent_h + conv
    assert sum(tail) - sum(tail[:3]) < parent_h + conv
    if ld <= 2 * hid:  # every gate wider than 3: nothing of the conv's size
        assert all(k < conv for k in (*gdfn, *tail[3:]))
    # the fp32 tail keeps its conv and its gate pass's rows in h's buffer
    assert tblock.fwd_workspace_numel(n, c, 2 * hid, True)[4] == conv


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_neither_bf16_forward_plans_a_gate_pass(b, h, w, c):
    """The bf16 tail's and GDFN's plans hold 0 in their gate-pass int (the
    kernels refuse a 1) and the gated depthwise's (vec, cv, tc, rows); the
    fp32 forms keep theirs: a pass where C spans more than one output tile."""
    hid = _hid(c)
    width = 2 * hid
    for n_sm in CARDS:
        dw = tdw.conv_gate_plan(b, h, w, hid, n_sm)
        tail = tblock.block_fwd_plan(b, h, w, c, width, True, n_sm, (1, 1, 1), dw, True)
        gdfn = tfused.fused_fwd_plan(b, h, w, c, width, True, n_sm, (1, 1, 1), dw, True)
        assert tail.gate_pass == tail.ints()[14] == 0 and tail.ints()[10:14] == dw
        assert gdfn.gate_pass == gdfn.ints()[12] == 0 and gdfn.ints()[8:12] == dw
        fp32 = tblock.block_fwd_plan(b, h, w, c, width, True, n_sm, (1, 1, 1), (1, 1, 1, 1))
        assert fp32.gate_pass == int(c > tblock.GATE_FUSED_MAX_C)
        fp32 = tfused.fused_fwd_plan(b, h, w, c, width, True, n_sm, (1, 1, 1), (1, 1, 1, 1))
        assert fp32.gate_pass == int(c > tfused.GATE_FUSED_MAX_C)
