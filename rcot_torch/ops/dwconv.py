"""Bias-free depthwise 3x3 SAME convolution on NHWC, forward and backward.

Counterpart of rcot_tpu/ops/pallas_dwconv.py (`dwconv3x3_fwd`, its
`_kernel` at :28-54, and the custom VJP `dwconv3x3_pallas` at :106-138),
the standalone depthwise tier that the JAX package runs with
RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1:

  dwconv3x3(x, taps):  x (B,H,W,C), taps (C,3,3) -> (B,H,W,C)

`DwConv3x3` is the autograd Function. As the JAX custom VJP does, its
backward computes dx with the forward's kernel on the cotangent, the taps
rotated by 180 degrees (inside the kernel; launches counted under
`dwconv3x3_dx`), and dtaps as the 9-tap pixel reduction sum g * x_shifted
(`dwconv3x3_dtaps`, a kernel of its own with a fixed-order sum, where the
JAX package uses jnp). A CUDA tensor goes to the kernels of csrc/dwconv.cu,
a CPU tensor to the plain twins `dwconv3x3_plain` (ops/conv.py
depthwise3x3) and `dwconv3x3_dtaps_plain`; the forward's launches are
counted under `dwconv3x3`.

bf16 (the tier's bf16 forms): x is bf16 and the taps stay fp32, as the JAX
package passes the depthwise weight uncast in this tier
(rcot_tpu/ops/attention.py:112-114, gdfn.py:66-67) and its kernel widens
both (pallas_dwconv.py:45-53). The forward and dx write bf16 (launches
`dwconv3x3_bf16`, `dwconv3x3_dx_bf16`), dtaps sums the widened x and g in
fp32 and stays fp32 (`dwconv3x3_dtaps_bf16`; pallas_dwconv.py:121-134),
so the fp32 parameter's gradient is never rounded to bf16. Their CPU twins
are `dwconv3x3_bf16_plain` and dtaps's plain twin on the widened values.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import build
from .conv import depthwise3x3
from .gram import SMEM_PER_SM, SMEM_RESERVED, _cdiv, sm_count

# The launch plan of csrc/dwconv.cu's kernels, a pure function of the shape,
# the vector width and the card: its SM count and the blocks an SM holds
# at once (the kernel's registers decide; blocks_per_sm reads it once per
# tile). A block owns `tc` columns by `cv` channel vectors (at most
# DW_VECTORS, tc * cv <= DW_THREADS threads; dwconv_tile) and walks a band
# of `rows` rows (dwconv_rows): the bands that give the most blocks up to
# DW_BLOCKS_PER_SM an SM (or up to what an SM holds, if fewer), the fewest
# bands (the longest runs down the rows) among equals. On the card, more
# blocks an SM on shorter bands ran slower at the level-1 shapes, even
# where all of them fit at once: at 256^2 by 510 channels one band of 256
# blocks beat two of 512 (PERF.md). Where one band alone gives more than
# DW_BLOCKS_PER_SM an SM, the bands fill waves of what the card
# holds at least DW_WAVE_FILL full, or as full as they can. No band is
# shorter than DW_MIN_ROWS unless the image is. dtaps's bands also hold at
# most DTAPS_MAX_PIXELS pixels a block: a block's sum over its pixels is one
# thread's fp32 sum down its rows and a fixed-order sum over its columns,
# and its error grows with them (as the Gram's, ops/gram.py
# GRAM_MAX_PIXELS).
DW_THREADS = 256
DW_VECTORS = 32
DW_BLOCKS_PER_SM = 3
DW_WAVE_FILL = 0.85
DW_MIN_ROWS = 4
DTAPS_MAX_PIXELS = 512


def dwconv_vec(c: int, *ptrs: int) -> int:
    """Floats a copy moves: 4 or 2 where they divide C and every pointer is
    aligned to that many floats, else 1."""
    for vec in (4, 2):
        if c % vec == 0 and all(p % (4 * vec) == 0 for p in ptrs):
            return vec
    return 1


def bf16_vec(c: int, *ptrs: int, f32_ptrs: Tuple[int, ...] = ()) -> int:
    """bf16 a copy moves in serving's bf16 kernels: 8, 4 or 2 where they
    divide C and every bf16 pointer is aligned to that many bf16 and every
    fp32 one (an fp32 output of as many values, stored 16 or 8 bytes at a
    time) to min(16, 4 * vec) bytes, else 1."""
    for vec in (8, 4, 2):
        if (c % vec == 0 and all(p % (2 * vec) == 0 for p in ptrs)
                and all(p % min(16, 4 * vec) == 0 for p in f32_ptrs)):
            return vec
    return 1


def dwconv_tile(c: int, w: int, vec: int) -> Tuple[int, int]:
    """-> (cv, tc): channel vectors and columns a block."""
    n_vec = c // vec
    cv = _cdiv(n_vec, _cdiv(n_vec, DW_VECTORS))
    return cv, min(DW_THREADS // cv, w)


def retile(plan: Tuple[int, int, int], c: int, vec: int) -> Tuple[int, int, int, int]:
    """-> (vec, cv, tc, rows) of a launch at vec elements a copy that keeps
    the columns a block (tc) and the band (rows) of plan = (cv, tc, rows),
    one planned at another copy width: dtaps's sums follow tc and rows alone,
    so a bf16 dtaps on plan's tiles adds in the order of plan's fp32 one. cv
    is dwconv_tile's, held to tc * cv <= DW_THREADS."""
    _, tc, rows = plan
    n_vec = c // vec
    cv = _cdiv(n_vec, _cdiv(n_vec, min(DW_VECTORS, DW_THREADS // tc)))
    return vec, cv, tc, rows


@functools.lru_cache(maxsize=None)
def dwconv_rows(b: int, h: int, w: int, c: int, vec: int, n_sm: int, per_sm: int,
                max_pixels: int = 0) -> int:
    """-> rows a band, on a card of n_sm SMs that holds per_sm blocks an SM
    at once (max_pixels, when not 0, caps tc * rows)."""
    cv, tc = dwconv_tile(c, w, vec)
    return band_rows(h, b * _cdiv(w, tc) * _cdiv(c // vec, cv), tc, n_sm, per_sm, max_pixels)


def band_rows(h: int, per_band: int, tc: int, n_sm: int, per_sm: int,
              max_pixels: int = 0) -> int:
    """-> rows a band of an image of h rows, for a launch of per_band blocks
    a band, tc columns each (dwconv_rows' rule)."""
    most_rows = min(h, max(1, max_pixels // tc)) if max_pixels else h
    dense, wave = min(DW_BLOCKS_PER_SM, per_sm) * n_sm, per_sm * n_sm
    runs = {_cdiv(h, bands) for bands in range(_cdiv(h, most_rows),
                                                _cdiv(h, min(DW_MIN_ROWS, most_rows)) + 1)}
    # rows -> blocks, the longest bands first
    blocks = {rows: per_band * _cdiv(h, rows) for rows in sorted(runs, reverse=True)}
    fitting = [rows for rows, n in blocks.items() if n <= dense]
    if fitting:
        return max(fitting, key=lambda rows: blocks[rows])
    fill = {rows: n / (_cdiv(n, wave) * wave) for rows, n in blocks.items()}
    full = [rows for rows in blocks if fill[rows] >= DW_WAVE_FILL]
    return full[0] if full else max(blocks, key=lambda rows: fill[rows])


# The element types of a launch: "f32" (fp32 in and out), the bf16 forward
# of serving's bf16 block kernels, into bf16 ("bf16", the head's and the
# qkv's) or fp32 ("bf16_f32", the bf16 backwards' conv), or the standalone
# tier's bf16 forms ("w32": bf16 x and out on fp32 taps, and dtaps on bf16 x
# and g; C entry points rcot_dwconv3x3_w32 and rcot_dwconv3x3_dtaps_w32);
# vec counts elements. The index is the C side's io. The gated depthwise of
# the bf16 tail and GDFN forwards is planned apart (conv_gate_plan).
DW_IO = ("f32", "bf16", "bf16_f32", "w32")


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device_index: int, vec: int, cv: int, tc: int, dtaps: bool,
                  io: str = "f32") -> int:
    """Blocks of this tile that one SM holds at once, for the forward (and
    dx) or for dtaps, of the element types io."""
    n = ctypes.c_int()
    with torch.cuda.device(device_index):
        build.call("rcot_dwconv3x3_blocks_per_sm", DW_IO.index(io), vec, cv, tc, int(dtaps),
                   ctypes.byref(n))
    return n.value


def dwconv_plan(b: int, h: int, w: int, c: int, device_index: int, vec: int,
                dtaps: bool, io: str = "f32") -> Tuple[int, int, int]:
    """-> (cv, tc, rows) of a launch on (B,H,W,C) on this card: the forward
    and dx (dtaps False) or dtaps, of the element types io (DW_IO)."""
    cv, tc = dwconv_tile(c, w, vec)
    return cv, tc, dwconv_rows(b, h, w, c, vec, sm_count(device_index),
                               blocks_per_sm(device_index, vec, cv, tc, dtaps, io),
                               DTAPS_MAX_PIXELS if dtaps else 0)


# The gated depthwise of the bf16 tail and GDFN forwards (csrc/dwconv.cu
# dwconv3x3_gate_kernel, rcot_dwconv::conv_gate_bf16): bf16 h (N, 2h) in,
# the bf16 gate gelu(c1) c2 out, in rows of gate_ld(h) = h rounded up to 8
# (zeros past h), the fp32 conv kept in registers. A thread owns GATE_COLS
# neighbouring columns of GATE_VEC channels of both halves, a block tc of
# those column groups by cv vectors (dwconv_tile over the gate's gate_ld
# channels and the image's column groups) and walks a band of rows
# (dwconv_rows), with the blocks an SM that its shared memory
# (conv_gate_smem: a ring of GATE_STAGES stages, each GATE_COLS tc + 2
# columns of c1's chunk and of c2's, which holds one vector more, then both
# halves' 9 taps a channel in fp32) and its launch bound
# (GATE_BLOCKS_PER_SM, which caps its registers) allow: pure functions of
# the shape and the card's SM count, held against the C side's by a cuda
# test. A copy of c1 moves GATE_VEC bf16 (4 bytes: 2h is even, so every
# row of h is 4-byte aligned); at odd h, c2 starts 2 bytes past a 4-byte
# column, and the kernel stages it from that column.
GATE_VEC = 2
GATE_COLS = 2
GATE_STAGES = 4
GATE_BLOCKS_PER_SM = 2


def gate_ld(hid: int) -> int:
    """bf16 between rows of the gate: hid rounded up to 8 (16 bytes)."""
    return _cdiv(hid, 8) * 8


def conv_gate_smem(cv: int, tc: int) -> int:
    """Bytes of shared memory a block of the gated depthwise takes
    (csrc/dwconv.cu gate_smem)."""
    ring = 2 * GATE_STAGES * (GATE_COLS * tc + 2) * (2 * cv * GATE_VEC + GATE_VEC)
    return _cdiv(ring, 16) * 16 + 4 * 18 * cv * GATE_VEC


def conv_gate_per_sm(cv: int, tc: int) -> int:
    """Blocks of the gated depthwise an SM holds at (cv, tc): what its
    launch bound and its shared memory both allow."""
    return min(GATE_BLOCKS_PER_SM, SMEM_PER_SM // (conv_gate_smem(cv, tc) + SMEM_RESERVED))


def conv_gate_plan(b: int, h: int, w: int, hid: int, n_sm: int) -> Tuple[int, int, int, int]:
    """-> (vec, cv, tc, rows) of the gated depthwise on h (B,H,W,2 hid) on a
    card of n_sm SMs, over the gate's gate_ld(hid) channels and the image's
    groups of GATE_COLS columns (a block spans GATE_COLS tc columns)."""
    ld, groups = gate_ld(hid), _cdiv(w, GATE_COLS)
    cv, tc = dwconv_tile(ld, groups, GATE_VEC)
    return GATE_VEC, cv, tc, dwconv_rows(b, h, groups, ld, GATE_VEC, n_sm,
                                         conv_gate_per_sm(cv, tc))


def conv_gate_vec(hid: int, h_ptr: int) -> int:
    """The gated depthwise's copy width of h (B,H,W,2 hid) at h_ptr:
    GATE_VEC, which needs h 4-byte aligned."""
    if bf16_vec(2 * hid, h_ptr) < GATE_VEC:
        raise ValueError("the gated depthwise reads h in copies of 4 bytes: h must be "
                         "4-byte aligned")
    return GATE_VEC


def conv_gate_plain(h: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The plain twin of the gated depthwise: [c1 | c2] = the depthwise of h
    (B,H,W,2 hid) on taps (2 hid,3,3) in fp32 (cuDNN's or the CPU's), gate =
    gelu(c1) c2 (exact erf) rounded once to h's dtype, in rows of
    gate_ld(hid) with zeros past hid."""
    hid = h.shape[-1] // 2
    c1, c2 = depthwise3x3(h.float(), taps.float()).chunk(2, dim=-1)
    gate = F.gelu(c1) * c2
    return F.pad(gate, (0, gate_ld(hid) - hid)).to(h.dtype)


def conv_gate_bf16(h: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The gated depthwise alone (the stage of the bf16 tail and GDFN
    forwards, which launch it inside their own calls): bf16 h (B,H,W,2 hid)
    and taps (2 hid,3,3) -> the bf16 gate (B,H,W,gate_ld(hid)), zeros past
    hid; a CPU tensor takes conv_gate_plain. Launches counted under
    conv_gate_bf16. On the card two calls give the same bits."""
    if not h.is_cuda:
        return conv_gate_plain(h, taps)
    b, hh, w, m = h.shape
    dev = h.device
    build.check_arg("h", h, (b, hh, w, m), dev, torch.bfloat16)
    build.check_arg("taps", taps, (m, 3, 3), dev, torch.bfloat16)
    if m % 2:
        raise ValueError(f"the gate needs an even width, got {m}")
    hid = m // 2
    gate = torch.empty(b, hh, w, gate_ld(hid), device=dev, dtype=torch.bfloat16)
    if h.numel() == 0:
        return gate
    vec, cv, tc, rows = conv_gate_plan(b, hh, w, hid, sm_count(dev.index))
    conv_gate_vec(hid, h.data_ptr())
    with torch.cuda.device(dev):
        build.call("rcot_conv_gate_bf16", h.data_ptr(), taps.data_ptr(), gate.data_ptr(),
                   b, hh, w, hid, gate_ld(hid), vec, cv, tc, rows, build.stream())
    build.LAUNCHES["conv_gate_bf16"] += 1
    return gate


# The product-depthwise of the bf16 head and qkv forwards (csrc/pw_dw.cu,
# rcot_pwdw::pw_dw_bf16): x (B,H,W,C) in (the head's LayerNorm output),
# qkv (B,H,W,M) out, the 1x1 product taken inside the depthwise's band, so
# that h never leaves the SM. A block owns PW_COLS output columns
# (a staged row is PW_PIXELS pixels: one 16-row mma tile) by cw of the M
# output channels, a multiple of 8 (the product's n tiles) up to
# PW_MAX_CHUNK (the stencil's threads, PW_VEC channels of one column each,
# fit DW_THREADS), as few chunks as it takes, then the narrowest; and walks
# a band of rows (band_rows, dwconv_rows' rule) in steps of pw_dw_group(C)
# input rows a barrier (more rows a step, fewer steps and more of each
# step's products in flight at once), with the blocks an SM that its shared
# memory (pw_dw_smem: a ring of PW_STAGES or two steps of staged rows, the
# W chunk, two steps' h rows, the taps) and its launch bound
# (PW_BLOCKS_PER_SM) allow: the chunk and ring that read x the fewest times
# for each block an SM holds (chunks over blocks an SM), the widest chunk
# and the deeper ring among equals (pw_dw_fit). Past C = 2,880
# (pw_dw_max_channels) no chunk fits: the head and the qkv then take their
# launches of old, through h in device memory. The product's K ranges are
# ops/block.py split_plan's (the caller's `split`), so that its sums keep
# mm.cuh's order. Pure functions of the shape and the card's SM count;
# held against the C side's by a cuda test. The plan's ints are
# PW_PLAN_INTS, pw_dw.cuh's order.
PW_COLS = 14
PW_PIXELS = PW_COLS + 2
PW_VEC = 4
PW_MAX_CHUNK = DW_THREADS // PW_COLS * PW_VEC // 8 * 8
PW_STEP = 32  # the product's K step (csrc/mm.cuh BK)
PW_STAGES = 3
PW_BLOCKS_PER_SM = 2
PW_PLAN_INTS = 8
# (most C, input rows a step): C decides the step, as the kernel's instances
PW_GROUPS = ((128, 4), (384, 2))


def pw_dw_group(c: int) -> int:
    """Input rows a step of the band at C channels (csrc/pw_dw.cu pw_group):
    the first of PW_GROUPS whose C is at least c, else one."""
    return next((r for most, r in PW_GROUPS if c <= most), 1)


def pw_dw_ldk(c: int) -> int:
    """bf16 between staged rows of x and of the W chunk: C in whole K
    steps, and 8."""
    return _cdiv(c, PW_STEP) * PW_STEP + 8


def pw_dw_ldh(cw: int) -> int:
    """bf16 between h's pixels: cw or more, 8 past a multiple of 16."""
    return cw + (24 - cw % 16) % 16


def pw_dw_smem(c: int, cw: int, stages: int) -> int:
    """Bytes of shared memory a block of the product-depthwise takes
    (csrc/pw_dw.cu pw_smem)."""
    r = pw_dw_group(c)
    return (2 * (stages * r * PW_PIXELS + cw) * pw_dw_ldk(c)
            + 2 * 2 * r * PW_PIXELS * pw_dw_ldh(cw) + 4 * 9 * cw)


def pw_dw_per_sm(c: int, cw: int, stages: int) -> int:
    """Blocks of the product-depthwise an SM holds: what its launch bound
    and its shared memory both allow (0: it does not fit)."""
    return min(PW_BLOCKS_PER_SM, SMEM_PER_SM // (pw_dw_smem(c, cw, stages) + SMEM_RESERVED))


def pw_dw_chunk(m: int, most: int = PW_MAX_CHUNK) -> int:
    """Output channels a block: the fewest chunks of at most `most`, each
    the narrowest multiple of 8 that holds M in that many."""
    return _cdiv(_cdiv(m, _cdiv(m, most)), 8) * 8


def pw_dw_fit(c: int, m: int) -> Optional[Tuple[int, int]]:
    """-> (cw, stages) of the product-depthwise at C channels in and M
    out: of the chunks pw_dw_chunk gives and rings of PW_STAGES or two that
    fit an SM, the least chunks over blocks an SM, then the widest chunk and
    the deeper ring; None where none fits."""
    fits = [(_cdiv(m, cw) / pw_dw_per_sm(c, cw, s), -cw, -s)
            for cw in {pw_dw_chunk(m, most) for most in range(PW_MAX_CHUNK, 0, -8)}
            for s in (PW_STAGES, 2) if pw_dw_per_sm(c, cw, s) >= 1]
    if not fits:
        return None
    _, cw, s = min(fits)
    return -cw, -s


def pw_dw_max_channels() -> int:
    """The most channels C the product-depthwise takes (its narrowest
    chunk, a ring of two)."""
    c = PW_STEP
    while pw_dw_per_sm(c + PW_STEP, 8, 2) >= 1:
        c += PW_STEP
    return c


def pw_dw_plan(b: int, h: int, w: int, c: int, m: int, n_sm: int, vec_c: int, vec_out: int,
               split: Tuple[int, int]) -> Optional[Tuple[int, ...]]:
    """-> the product-depthwise's plan on x (B,H,W,C) into (B,H,W,M) on a
    card of n_sm SMs, PW_PLAN_INTS ints: vec_c bf16 a copy of x's and W's
    rows, vec_out bf16 a store of the output (4, or 2 where M or its
    address holds no four), cw, rows, stages, the input rows a step
    (pw_dw_group), and the product's split = (K ranges, depth a range)
    (ops/block.py split_plan); None where it does not fit the card
    (pw_dw_fit)."""
    fit = pw_dw_fit(c, m)
    if fit is None:
        return None
    cw, stages = fit
    per_band = b * _cdiv(w, PW_COLS) * _cdiv(m, cw)
    rows = band_rows(h, per_band, PW_COLS, n_sm, pw_dw_per_sm(c, cw, stages))
    parts, k_per = split
    out = (vec_c, min(vec_out, PW_VEC), cw, rows, stages, pw_dw_group(c), parts,
           k_per if parts > 1 else c)
    assert len(out) == PW_PLAN_INTS
    return out


def _plan(x: torch.Tensor, dtaps: bool, *ptrs: int) -> Tuple[int, int, int, int]:
    """-> (vec, cv, tc, rows) of a launch on x (B,H,W,C) and the tensors at
    ptrs: fp32, or bf16 on fp32 taps (io "w32", which takes no
    element-wise copies: an odd C raises)."""
    c = x.shape[-1]
    if x.dtype != torch.bfloat16:
        vec = dwconv_vec(c, *ptrs)
        return (vec, *dwconv_plan(*x.shape, x.device.index, vec, dtaps))
    vec = bf16_vec(c, *ptrs)
    if vec == 1:
        raise ValueError(f"bf16 depthwise kernels take an even C, aligned: C = {c}")
    return (vec, *dwconv_plan(*x.shape, x.device.index, vec, dtaps, "w32"))


def dtaps_workspace_numel(b: int, h: int, w: int, c: int, tc: int, rows: int) -> int:
    """Floats of workspace dtaps needs: 9C partial sums per block range of
    (image, band, column tile)."""
    return b * _cdiv(h, rows) * _cdiv(w, tc) * 9 * c


def dwconv3x3_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The plain twin: cuDNN's (or the CPU's) depthwise convolution."""
    return depthwise3x3(x, taps)


def dwconv3x3_bf16_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The plain twin of the bf16 forward: x widened times the fp32 taps,
    the nine terms summed in fp32 dy-major, dx-minor, each product rounded
    before its add, as the JAX kernel's (pallas_dwconv.py:45-53), then
    rounded once to x's dtype."""
    h, w = x.shape[1:3]
    xp, t = F.pad(x.float(), (0, 0, 1, 1, 1, 1)), taps.float()
    acc = xp[:, :h, :w] * t[:, 0, 0]
    for k in range(1, 9):
        i, j = divmod(k, 3)
        acc = acc + xp[:, i:i + h, j:j + w] * t[:, i, j]
    return acc.to(x.dtype)


def dwconv3x3_dtaps_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain twin of dtaps: nine products and sums in PyTorch ops."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dtaps = torch.stack([(g * xp[:, i:i + h, j:j + w]).sum(dim=(0, 1, 2))
                         for i in range(3) for j in range(3)], dim=-1)
    return dtaps.reshape(-1, 3, 3)


def _launch(x: torch.Tensor, taps: torch.Tensor, name: str, rot: bool) -> torch.Tensor:
    bf16 = x.dtype == torch.bfloat16
    if not x.is_cuda:
        plain = dwconv3x3_bf16_plain if bf16 else dwconv3x3_plain
        return plain(x, taps.flip(1, 2) if rot else taps)
    b, h, w, c = x.shape
    dev = x.device
    build.check_arg("x", x, (b, h, w, c), dev, build.kernel_dtype(x))
    build.check_arg("taps", taps, (c, 3, 3), dev)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    vec, cv, tc, rows = _plan(x, False, x.data_ptr(), out.data_ptr())
    entry = "rcot_dwconv3x3_w32" if bf16 else "rcot_dwconv3x3"
    with torch.cuda.device(dev):
        build.call(entry, x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                   b, h, w, c, vec, cv, tc, rows, int(rot), build.stream())
    build.LAUNCHES[name + ("_bf16" if bf16 else "")] += 1
    return out


def dwconv3x3_fwd(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C), taps (C,3,3) -> (B,H,W,C), zeros outside the image."""
    return _launch(x, taps, "dwconv3x3", rot=False)


def dwconv3x3_dx(g: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """dx of dwconv3x3_fwd for the cotangent g: the forward on g with the
    taps rotated by 180 degrees (pallas_dwconv.py:118-120), in the kernel."""
    return _launch(g, taps, "dwconv3x3_dx", rot=True)


def dwconv3x3_dtaps(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dtaps of dwconv3x3_fwd for the cotangent g: dtaps[c, i, j] = sum over
    pixels of g[b, y, x, c] * x[b, y + i - 1, x + j - 1, c]
    (pallas_dwconv.py:121-134). On the card the sums run in a fixed order,
    so two calls on the same input give the same bits. fp32 for a bf16 x
    and g too: their widened products, summed in fp32."""
    bf16 = x.dtype == torch.bfloat16
    if not x.is_cuda:
        if bf16:
            x, g = x.float(), g.float()
        return dwconv3x3_dtaps_plain(x, g)
    b, h, w, c = x.shape
    dev = x.device
    build.check_arg("x", x, (b, h, w, c), dev, build.kernel_dtype(x))
    build.check_arg("g", g, (b, h, w, c), dev, build.kernel_dtype(x))
    if x.numel() == 0:
        return torch.zeros(c, 3, 3, device=dev)
    vec, cv, tc, rows = _plan(x, True, x.data_ptr(), g.data_ptr())
    ws = torch.empty(dtaps_workspace_numel(b, h, w, c, tc, rows), device=dev)
    dtaps = torch.empty(c, 3, 3, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_dwconv3x3_dtaps_w32" if bf16 else "rcot_dwconv3x3_dtaps",
                   x.data_ptr(), g.data_ptr(), ws.data_ptr(),
                   dtaps.data_ptr(), b, h, w, c, vec, cv, tc, rows, build.stream())
    build.LAUNCHES["dwconv3x3_dtaps" + ("_bf16" if bf16 else "")] += 1
    return dtaps


def dwconv3x3_bwd(x: torch.Tensor, taps: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of dwconv3x3_fwd for the cotangent g -> (dx, dtaps)."""
    return dwconv3x3_dx(g, taps), dwconv3x3_dtaps(x, g)


class DwConv3x3(torch.autograd.Function):
    """dwconv3x3_fwd with its backward; saves x and the taps
    (pallas_dwconv.py _fwd). For a bf16 x the taps are fp32 and so is their
    gradient."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.save_for_backward(x, taps)
        return dwconv3x3_fwd(x, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.chunk's backward may arrive here
        return dwconv3x3_bwd(*ctx.saved_tensors, g.contiguous())


def dwconv3x3(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The bias-free depthwise 3x3 SAME conv, differentiable: x (B,H,W,C),
    taps (C,3,3) -> (B,H,W,C)."""
    return DwConv3x3.apply(x, taps)
