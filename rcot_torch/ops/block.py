"""Fused transformer-block head and tail, forward and backward.

Counterpart of rcot_tpu/ops/pallas_block.py:

  block_head: qkv = dw3x3( LN1(x) @ W_qkv )
  block_tail: t = x + a @ W_proj
              y = t + ( gelu(c1) * c2 ) @ W_out,  [c1 | c2] = dw3x3( LN2(t) @ W_in )

Weights are taken in PyTorch's conv layouts, as the modules hold them:
w_qkv (3C, C), w_proj (C, C), w_in (2h, C), w_out (C, h) and depthwise
kernels (M, 3, 3); the backward returns their grads in the same layouts.

`block_head` and `block_tail` are autograd Functions (BlockHead,
BlockTail). As the JAX custom VJP does, the forward saves only the inputs
and weights, and the backward recomputes the rest. A CUDA tensor goes to
the kernels of csrc/block_fwd.cu and csrc/block_bwd.cu; a CPU tensor to the
plain twins below, composed from the port's ops and differentiated by
autograd, so they share none of the kernels' formulas. The kernels take
their launch plans from block_fwd_plan and block_bwd_plan below.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import dwconv as kdw
from .conv import conv1x1, depthwise3x3
from .gdfn import gated
from .gram import GRAM_MAX_PIXELS, _cdiv, sm_count
from .layernorm import layernorm


# ------------------------------------------------------------------ plain

def block_head_plain(x, ln_w, ln_b, w_qkv, dwk):
    return depthwise3x3(conv1x1(layernorm(x, ln_w, ln_b), w_qkv), dwk)


def block_tail_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out):
    t = x + conv1x1(a, w_proj)
    h = depthwise3x3(conv1x1(layernorm(t, ln_w, ln_b), w_in), dwk)
    return t + conv1x1(gated(h), w_out)


def _vjp_plain(fn, inputs, g):
    """Grads of fn(*inputs) for the cotangent g, by autograd on the plain
    forward; None stays None."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in inputs]
        out = fn(*leaves)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, live, g))
    return tuple(None if t is None else next(grads) for t in leaves)


def block_head_bwd_plain(x, ln_w, ln_b, w_qkv, dwk, g):
    """-> (dx, dln_w, dln_b, dw_qkv, ddw)."""
    return _vjp_plain(block_head_plain, (x, ln_w, ln_b, w_qkv, dwk), g)


def block_tail_bwd_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g):
    """-> (dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out)."""
    return _vjp_plain(block_tail_plain,
                      (x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out), g)


# ---------------------------------------------------------------- kernels

def block_head_fwd(x: torch.Tensor, ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
                   w_qkv: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) -> qkv (B,H,W,M); w_qkv (M,C), dwk (M,3,3). On the card
    two calls on the same inputs give the same bits."""
    if not x.is_cuda:
        return block_head_plain(x, ln_w, ln_b, w_qkv, dwk)
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    n = b * h * w
    dev = x.device
    for name, t, shape in (("x", x, (b, h, w, c)), ("ln_w", ln_w, (c,)),
                           ("ln_b", ln_b, (c,)), ("w_qkv", w_qkv, (m, c)),
                           ("dwk", dwk, (m, 3, 3))):
        build.check_arg(name, t, shape, dev)
    _check_channels(c)
    out = torch.empty(b, h, w, m, device=dev)
    # u, stats, h
    buf, ws = _workspaces(dev, fwd_workspace_numel(n, c, m, False))
    vecs = fwd_vecs(c, m, False, {"u": ws[0], "w_qkv": w_qkv.data_ptr(), "h": ws[2],
                                  "out": out.data_ptr()})
    plan, n_sums = _fwd_card_plan(b, h, w, c, m, False, dev.index, *vecs)
    sums = torch.empty(n_sums, device=dev) if n_sums else None
    with torch.cuda.device(dev):
        build.call("rcot_block_head", x.data_ptr(), ln_w.data_ptr(), build.ptr(ln_b),
                   w_qkv.data_ptr(), dwk.data_ptr(), out.data_ptr(), *ws, build.ptr(sums),
                   plan, b, h, w, c, m, build.stream())
    build.LAUNCHES["block_head"] += 1
    return out


def block_tail_fwd(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
                   ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
                   w_in: torch.Tensor, dwk: torch.Tensor,
                   w_out: torch.Tensor) -> torch.Tensor:
    """x, a (B,H,W,C) -> y (B,H,W,C); w_proj (C,C), w_in (2h,C),
    dwk (2h,3,3), w_out (C,h). On the card two calls on the same inputs
    give the same bits."""
    if not x.is_cuda:
        return block_tail_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    n = b * h * w
    dev = x.device
    for name, t, shape in (("x", x, (b, h, w, c)), ("a", a, (b, h, w, c)),
                           ("w_proj", w_proj, (c, c)), ("ln_w", ln_w, (c,)),
                           ("ln_b", ln_b, (c,)), ("w_in", w_in, (2 * hid, c)),
                           ("dwk", dwk, (2 * hid, 3, 3)), ("w_out", w_out, (c, hid))):
        build.check_arg(name, t, shape, dev)
    _check_channels(c)
    y = torch.empty_like(x)
    # t, stats, u, h, conv
    buf, ws = _workspaces(dev, fwd_workspace_numel(n, c, 2 * hid, True))
    ptrs = {"a": a.data_ptr(), "u": ws[2], "w_proj": w_proj.data_ptr(),
            "w_in": w_in.data_ptr(), "h": ws[3], "conv": ws[4], "w_out": w_out.data_ptr()}
    plan, n_sums = _fwd_card_plan(b, h, w, c, 2 * hid, True, dev.index,
                                  *fwd_vecs(c, 2 * hid, True, ptrs))
    sums = torch.empty(n_sums, device=dev) if n_sums else None
    with torch.cuda.device(dev):
        build.call("rcot_block_tail",
                   *(t.data_ptr() for t in (x, a, w_proj, ln_w)), build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_in, dwk, w_out, y)), *ws, build.ptr(sums),
                   plan, b, h, w, c, hid, build.stream())
    build.LAUNCHES["block_tail"] += 1
    return y


# The launch plan of csrc/block_bwd.cu's backward kernels, a pure function
# of the shape, the copy widths and the card (its SM count, and the blocks
# an SM holds of row 11's kernels, which run the depthwise stages); the
# kernels take it as it is, as PLAN_INTS ints (the order of its fields).
# The 1x1 products run in MM_TILE_M x MM_TILE_N output tiles, MM_STEP deep
# (the kernel's BM, BN, BK), about SUM_BLOCKS_PER_SM blocks an SM at once
# (its shared memory, 81 KB a block, and its launch bounds let two fit).
# A pixel sum (dW_out, dW_in, dW_proj, dW_qkv) splits the pixels into
# contiguous ranges of a multiple of MM_STEP and at most SUM_MAX_PIXELS
# pixels, one block each per output tile, so that the blocks come to about
# SUM_BLOCKS_PER_SM an SM: a block's fp32 sum grows in error with its
# pixels (ops/gram.py GRAM_MAX_PIXELS), and the cap holds it at any image
# size. A per-pixel product (t, h, du, da) whose output tiles come to fewer
# than that splits its depth K into ranges of whole steps, at least
# SPLIT_MIN_STEPS each, as many as fill the card. Every split's partials
# are added in a fixed order by a second launch. The LayerNorm backward
# takes ranges of pixels a multiple of LN_WARPS, about LN_BLOCKS_PER_SM
# blocks an SM, at most SUM_MAX_PIXELS each, and adds their partial dln_w,
# dln_b in order; the forward runs LN_BLOCKS_PER_SM blocks an SM. A lane
# of either holds its channels in registers up to 512 and walks them in
# device memory above; there the backward's warps keep their partials of
# dln_w and dln_b in shared memory, LN_WARPS * 2C floats of a block's
# SMEM_BYTES: C <= LN_MAX_CHANNELS. Each operand is copied 4, 2 or 1
# floats at a time (kdw.dwconv_vec: the widest that its width divides and
# its pointer's alignment allows), one width per width class: C, h (W_out's
# rows and the gate) and the depthwise width M (2h in the tail, 3C in the
# head).
MM_TILE_M, MM_TILE_N, MM_STEP = 128, 64, 32
SUM_MAX_PIXELS = GRAM_MAX_PIXELS
SUM_BLOCKS_PER_SM = 2
SPLIT_MIN_STEPS = 4
LN_WARPS = 8
LN_BLOCKS_PER_SM = 8
SMEM_BYTES = 232448
LN_MAX_CHANNELS = SMEM_BYTES // (4 * 2 * LN_WARPS)
PLAN_INTS = 28


class BwdPlan(NamedTuple):
    """A backward's launch plan; `ints()` is what the kernel takes."""
    ln_blocks: int                      # blocks of the LayerNorm forward
    ln_per: int                         # pixels a block of its backward
    sum_per: Tuple[int, int, int]       # pixels a range: dW_out, dW_in, dW_proj (head: dW_qkv, 0, 0)
    vec_c: int                          # copy widths of the C-, h- and M-wide operands
    vec_h: int
    vec_m: int
    splits: Tuple[Tuple[int, int], ...]  # (K ranges, depth a range) of t, h, du, da
    dw_conv: Tuple[int, int, int, int]  # (vec, cv, tc, rows) of the depthwise forward
    dw_rot: Tuple[int, int, int, int]   # ... its rotated forward (dh)
    dw_taps: Tuple[int, int, int, int]  # ... its dtaps
    sums_numel: int                     # floats of the sums workspace

    def ints(self) -> Tuple[int, ...]:
        out = (self.ln_blocks, self.ln_per, *self.sum_per, self.vec_c, self.vec_h,
               self.vec_m, *(k for split in self.splits for k in split), *self.dw_conv,
               *self.dw_rot, *self.dw_taps)
        assert len(out) == PLAN_INTS
        return out


def sum_plan(m: int, n: int, pixels: int, n_sm: int) -> Tuple[int, int]:
    """-> (ranges, pixels a range) of the pixel sum of an m x n output:
    range r covers pixels [r * per, min((r + 1) * per, pixels))."""
    tiles = _cdiv(m, MM_TILE_M) * _cdiv(n, MM_TILE_N)
    want = max(1, _cdiv(SUM_BLOCKS_PER_SM * n_sm, tiles))
    per = min(SUM_MAX_PIXELS, _cdiv(_cdiv(pixels, want), MM_STEP) * MM_STEP)
    return _cdiv(pixels, per), per


def sum_workspace_numel(m: int, n: int, pixels: int, n_sm: int) -> int:
    """Floats of workspace one pixel sum needs: a partial m x n per range,
    none when one range holds every pixel."""
    ranges, _ = sum_plan(m, n, pixels, n_sm)
    return 0 if ranges == 1 else ranges * m * n


def split_plan(pixels: int, n: int, k: int, n_sm: int) -> Tuple[int, int]:
    """-> (K ranges, depth a range) of the per-pixel product of a pixels x
    n output over depth k: range r covers [r * per, min((r + 1) * per, k))."""
    tiles = _cdiv(pixels, MM_TILE_M) * _cdiv(n, MM_TILE_N)
    steps = _cdiv(k, MM_STEP)
    want = max(1, min(SUM_BLOCKS_PER_SM * n_sm // tiles, steps // SPLIT_MIN_STEPS))
    per = _cdiv(steps, want)
    return _cdiv(steps, per), per * MM_STEP


def ln_plan(pixels: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks of the LayerNorm forward, pixels a block of its
    backward); the backward's block r covers [r * per, ...)."""
    fwd = max(1, min(_cdiv(pixels, LN_WARPS), LN_BLOCKS_PER_SM * n_sm))
    per = _cdiv(_cdiv(pixels, LN_BLOCKS_PER_SM * n_sm), LN_WARPS) * LN_WARPS
    return fwd, max(LN_WARPS, min(SUM_MAX_PIXELS, per))


def block_bwd_plan(b: int, h: int, w: int, c: int, width: int, tail: bool, n_sm: int,
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int],
                   dw_taps: Tuple[int, int, int, int]) -> BwdPlan:
    """The plan of a backward on (B,H,W,C) with depthwise width `width`
    (2h in the tail, 3C in the head) on a card of n_sm SMs; dw_conv and
    dw_taps are row 11's (vec, cv, tc, rows) on (B,H,W,width) for its
    forward (and rotated forward) and its dtaps."""
    n = b * h * w
    ln_blocks, ln_per = ln_plan(n, n_sm)
    # (m, n) of each pixel sum; (n, k) of t, h, du, da (None: not run)
    if tail:
        sums = ((c, width // 2), (width, c), (c, c))
        prods = ((c, c), (width, c), (c, width), (c, c))
    else:
        sums = ((width, c),)
        prods = (None, (width, c), (c, width), None)
    per = tuple(sum_plan(m, k, n, n_sm)[1] for m, k in sums)
    splits = tuple((1, 0) if nk is None else split_plan(n, *nk, n_sm) for nk in prods)
    numel = max([sum_workspace_numel(m, k, n, n_sm) for m, k in sums]
                + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1]
                + [_cdiv(n, ln_per) * 2 * c,
                   kdw.dtaps_workspace_numel(b, h, w, width, dw_taps[2], dw_taps[3])])
    return BwdPlan(ln_blocks, ln_per, per + (0,) * (3 - len(per)), *vecs, splits,
                   dw_conv if tail else (0, 0, 0, 0), dw_conv, dw_taps, numel)


@functools.lru_cache(maxsize=None)
def _card_plan(b, h, w, c, width, tail, device_index, vec_c, vec_h, vec_m):
    """-> (the plan's ints as a ctypes array, floats of sums) on this card."""
    dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False))
    dw_taps = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, True))
    plan = block_bwd_plan(b, h, w, c, width, tail, sm_count(device_index),
                          (vec_c, vec_h, vec_m), dw_conv, dw_taps)
    return (ctypes.c_int * PLAN_INTS)(*plan.ints()), plan.sums_numel


def _check_channels(c: int) -> None:
    if c > LN_MAX_CHANNELS:
        raise ValueError(f"{c} channels > {LN_MAX_CHANNELS} is not supported by the "
                         "block kernels' LayerNorm backward (its partials in shared memory)")


# The launch plan of csrc/block_fwd.cu's forward kernels, made as the
# backward's is (the same products, LayerNorm and depthwise forward): the
# LayerNorm forward's blocks (ln_plan), the K splits of the per-pixel
# products t, h and out (the tail's gated W_out product; split_plan) and
# row 11's (vec, cv, tc, rows) of the depthwise forward, as FWD_PLAN_INTS
# ints. Copy widths come in width classes, C (a, u, W_proj, W_in, W_qkv),
# h (either half of conv, W_out's rows) and the gate's rows: an odd h
# leaves the c2 half 4-byte aligned, and its class takes 4-byte copies;
# the gate of a gate pass lies in rows padded to 4 floats (gate_ld).
# The tail's W_out product takes the gate gelu(c1) c2 as it stages conv
# where C <= GATE_FUSED_MAX_C, one output tile wide; a wider C would take
# it anew in each of its output tiles, and the gate is a pass of its own
# into h's buffer, read by a plain product (gate_pass). On the card the
# fused gate was the faster at C = 48 and the pass from C = 96 up (PERF.md).
FWD_PLAN_INTS = 15
GATE_FUSED_MAX_C = MM_TILE_N


class FwdPlan(NamedTuple):
    """A forward's launch plan; `ints()` is what the kernel takes."""
    ln_blocks: int                       # blocks of the LayerNorm forward
    vec_c: int                           # copy widths of the C- and h-wide operands
    vec_h: int
    vec_g: int                           # ... and of the gate's padded rows
    splits: Tuple[Tuple[int, int], ...]  # (K ranges, depth a range) of t, h, out
    dw_conv: Tuple[int, int, int, int]   # (vec, cv, tc, rows) of the depthwise forward
    gate_pass: int                       # 1: the tail's gate as a pass of its own
    sums_numel: int                      # floats of the split partials' workspace

    def ints(self) -> Tuple[int, ...]:
        out = (self.ln_blocks, self.vec_c, self.vec_h, self.vec_g,
               *(k for split in self.splits for k in split), *self.dw_conv, self.gate_pass)
        assert len(out) == FWD_PLAN_INTS
        return out


def block_fwd_plan(b: int, h: int, w: int, c: int, width: int, tail: bool, n_sm: int,
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int]) -> FwdPlan:
    """The plan of a forward on (B,H,W,C) with depthwise width `width` (2h
    in the tail, 3C in the head) on a card of n_sm SMs; vecs the copy
    widths of the C class, the h class and the gate's rows, dw_conv row
    11's (vec, cv, tc, rows) on (B,H,W,width)."""
    n = b * h * w
    # (n, k) of t, h and out (None: not run)
    prods = ((c, c), (width, c), (c, width // 2)) if tail else (None, (width, c), None)
    splits = tuple((1, 0) if nk is None else split_plan(n, *nk, n_sm) for nk in prods)
    numel = max([0] + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1])
    return FwdPlan(ln_plan(n, n_sm)[0], *vecs, splits, dw_conv,
                   int(tail and c > GATE_FUSED_MAX_C), numel)


def _workspaces(dev, sizes) -> Tuple[torch.Tensor, list]:
    """One allocation that holds workspaces of these sizes (floats), each
    starting on a 512-byte boundary, as the caching allocator's blocks do
    -> (the tensor, which must outlive the launch, and their addresses)."""
    starts, total = [], 0
    for k in sizes:
        starts.append(total)
        total += _cdiv(k, 128) * 128
    buf = torch.empty(total, device=dev)
    return buf, [buf.data_ptr() + 4 * s for s in starts]


def gate_ld(hid: int) -> int:
    """Floats between rows of a gate pass's gate: hid rounded up to 4."""
    return _cdiv(hid, 4) * 4


def fwd_workspace_numel(n: int, c: int, width: int, tail: bool) -> Tuple[int, ...]:
    """Floats of each workspace of a forward on n pixels, in the order the
    kernel takes them: the tail's t, stats, u, h, conv (h's buffer takes
    the gate of a gate pass, n rows of gate_ld(h)), the head's u, stats, h."""
    if tail:
        return n * c, 2 * n, n * c, n * max(width, gate_ld(width // 2)), n * width
    return n * c, 2 * n, n * width


def fwd_vecs(c: int, width: int, tail: bool, ptrs: dict) -> Tuple[int, int, int, int]:
    """-> copy widths of the C class, the h class, the gate's rows and the
    depthwise width of a forward whose operands start at ptrs (name ->
    address): the tail's a, u, w_proj, w_in, h, conv, w_out, the head's u,
    w_qkv, h, out. The h class takes conv's two halves (at columns 0 and h
    of its rows) and W_out's rows, the gate's rows lie gate_ld(h) floats
    apart in h's buffer; the head has neither (1)."""
    if tail:
        hid = width // 2
        return (kdw.dwconv_vec(c, *(ptrs[k] for k in ("a", "u", "w_proj", "w_in"))),
                kdw.dwconv_vec(hid, *(ptrs[k] for k in ("conv", "w_out"))),
                kdw.dwconv_vec(gate_ld(hid), ptrs["h"]),
                kdw.dwconv_vec(width, ptrs["h"], ptrs["conv"]))
    return (kdw.dwconv_vec(c, ptrs["u"], ptrs["w_qkv"]), 1, 1,
            kdw.dwconv_vec(width, ptrs["h"], ptrs["out"]))


@functools.lru_cache(maxsize=None)
def _fwd_card_plan(b, h, w, c, width, tail, device_index, vec_c, vec_h, vec_g, vec_m):
    """-> (the forward plan's ints as a ctypes array, floats of sums) on this card."""
    dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False))
    plan = block_fwd_plan(b, h, w, c, width, tail, sm_count(device_index),
                          (vec_c, vec_h, vec_g), dw_conv)
    return (ctypes.c_int * FWD_PLAN_INTS)(*plan.ints()), plan.sums_numel


def block_head_bwd(x, ln_w, ln_b, w_qkv, dwk, g):
    """Backward of block_head for the cotangent g (B,H,W,M) ->
    (dx, dln_w, dln_b, dw_qkv, ddw); dln_b is None when ln_b is. On the
    card every sum runs in a fixed order, so two calls on the same inputs
    give the same bits."""
    if not x.is_cuda:
        return block_head_bwd_plain(x, ln_w, ln_b, w_qkv, dwk, g)
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    n = b * h * w
    dev = x.device
    for name, t, shape in (("x", x, (b, h, w, c)), ("ln_w", ln_w, (c,)),
                           ("ln_b", ln_b, (c,)), ("w_qkv", w_qkv, (m, c)),
                           ("dwk", dwk, (m, 3, 3)), ("g", g, (b, h, w, m))):
        build.check_arg(name, t, shape, dev)
    _check_channels(c)
    dx = torch.empty_like(x)
    dln_w = torch.empty_like(ln_w)
    dln_b = None if ln_b is None else torch.empty_like(ln_b)
    dw_qkv = torch.empty_like(w_qkv)
    ddw = torch.empty_like(dwk)
    # u, stats, h, dh, du
    u, stats, hbuf, dh, du = (torch.empty(k, device=dev)
                              for k in (n * c, 2 * n, n * m, n * m, n * c))
    vec_c = kdw.dwconv_vec(c, u.data_ptr(), w_qkv.data_ptr())
    vec_m = kdw.dwconv_vec(m, g.data_ptr(), hbuf.data_ptr(), dh.data_ptr())
    plan, n_sums = _card_plan(b, h, w, c, m, False, dev.index, vec_c, 1, vec_m)
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_block_head_bwd", x.data_ptr(), ln_w.data_ptr(),
                   build.ptr(ln_b), w_qkv.data_ptr(), dwk.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), dln_w.data_ptr(),
                   build.ptr(dln_b), dw_qkv.data_ptr(), ddw.data_ptr(),
                   *(t.data_ptr() for t in (u, stats, hbuf, dh, du, sums)), plan,
                   b, h, w, c, m, build.stream())
    build.LAUNCHES["block_head_bwd"] += 1
    return dx, dln_w, dln_b, dw_qkv, ddw


def block_tail_bwd(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g):
    """Backward of block_tail for the cotangent g (B,H,W,C) ->
    (dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out); dln_b is None when
    ln_b is. On the card every sum runs in a fixed order, so two calls on
    the same inputs give the same bits."""
    if not x.is_cuda:
        return block_tail_bwd_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk,
                                    w_out, g)
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    n = b * h * w
    dev = x.device
    for name, t, shape in (("x", x, (b, h, w, c)), ("a", a, (b, h, w, c)),
                           ("w_proj", w_proj, (c, c)), ("ln_w", ln_w, (c,)),
                           ("ln_b", ln_b, (c,)), ("w_in", w_in, (2 * hid, c)),
                           ("dwk", dwk, (2 * hid, 3, 3)),
                           ("w_out", w_out, (c, hid)), ("g", g, (b, h, w, c))):
        build.check_arg(name, t, shape, dev)
    _check_channels(c)
    outs = [torch.empty_like(t) for t in (x, a, w_proj, ln_w)]
    dln_b = None if ln_b is None else torch.empty_like(ln_b)
    outs += [dln_b] + [torch.empty_like(t) for t in (w_in, dwk, w_out)]
    # t, stats, u, h, conv/dh, dconv, gate, du
    sizes = (n * c, 2 * n, n * c, 2 * n * hid, 2 * n * hid, 2 * n * hid, n * hid, n * c)
    ws = [torch.empty(k, device=dev) for k in sizes]
    u, hbuf, conv_dh, dconv, gate = ws[2], ws[3], ws[4], ws[5], ws[6]
    vec_c = kdw.dwconv_vec(c, *(t.data_ptr() for t in (a, g, u, outs[0], w_proj, w_in)))
    vec_h = kdw.dwconv_vec(hid, w_out.data_ptr(), gate.data_ptr())
    vec_m = kdw.dwconv_vec(2 * hid, hbuf.data_ptr(), conv_dh.data_ptr(), dconv.data_ptr())
    plan, n_sums = _card_plan(b, h, w, c, 2 * hid, True, dev.index, vec_c, vec_h, vec_m)
    ws.append(torch.empty(n_sums, device=dev))
    with torch.cuda.device(dev):
        build.call("rcot_block_tail_bwd",
                   *(t.data_ptr() for t in (x, a, w_proj, ln_w)),
                   build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_in, dwk, w_out, g)),
                   *(build.ptr(t) for t in outs),
                   *(t.data_ptr() for t in ws), plan, b, h, w, c, hid, build.stream())
    build.LAUNCHES["block_tail_bwd"] += 1
    return tuple(outs)


# --------------------------------------------------------------- autograd

class BlockHead(torch.autograd.Function):
    """block_head with its backward kernel; saves only inputs and weights."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, dwk):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, dwk)
        return block_head_fwd(x, ln_w, ln_b, w_qkv, dwk)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.cat's backward arrives here
        return block_head_bwd(*ctx.saved_tensors, g.contiguous())


class BlockTail(torch.autograd.Function):
    """block_tail with its backward kernel; saves only inputs and weights."""

    @staticmethod
    def forward(ctx, x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out):
        ctx.save_for_backward(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
        return block_tail_fwd(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return block_tail_bwd(*ctx.saved_tensors, g.contiguous())


def block_head(x: torch.Tensor, ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
               w_qkv: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """Differentiable block head: x (B,H,W,C) -> qkv (B,H,W,M)."""
    return BlockHead.apply(x, ln_w, ln_b, w_qkv, dwk)


def block_tail(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
               ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
               w_in: torch.Tensor, dwk: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """Differentiable block tail: x, a (B,H,W,C) -> y (B,H,W,C)."""
    return BlockTail.apply(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
