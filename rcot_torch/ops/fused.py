"""Fused [1x1 ->] depthwise 3x3 [-> gelu gate -> 1x1], forward and backward.

Counterpart of rcot_tpu/ops/pallas_fused.py, in the two configurations the
model calls:

  conv1x1_dw_fused(x, w_in, dwk):        qkv = dw3x3( x @ W_in^T )
  gdfn_fused(x, w_in, dwk, w_out):       y = ( gelu(c1) * c2 ) @ W_out^T,
                                         [c1 | c2] = dw3x3( x @ W_in^T )

Weights are in the port's layouts, as ops/block.py takes them: w_in (M, C),
dwk (M, 3, 3), w_out (C, h) with M = 2h in the GDFN. The odd gate widths
of the reference model (h = 127, 255, ...) take narrower copies in the
kernels; nothing is padded.

`FusedDwconv` is the autograd Function. As the JAX custom VJP does, its
forward saves only x and the weights, and the backward recomputes the
rest. A CUDA tensor goes to the kernels of csrc/fused_dwconv.cu, a CPU
tensor to the plain twins below (composed from the port's ops, the backward
by autograd on them). The kernels take their launch plans from
fused_fwd_plan and fused_bwd_plan below. Launches are counted under
conv1x1_dw, gdfn_fused and their *_bwd names.

bf16 (bf16 training in "tail", the qkv configuration only): a bf16 x with
bf16 weights goes to csrc/fused_dwconv_bf16.cu on the card, counted as
conv1x1_dw_bf16 and conv1x1_dw_bwd_bf16. The forward twin rounds h and the
output to bf16 where the JAX kernel does (pallas_fused.py:153-183); the
backward twin is the JAX backward kernel's (:297-410): h recomputed and
rounded, then everything in fp32, each grad rounded once (ops/block.py
_vjp_widened). The GDFN configuration in bf16 stops by name.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import dwconv as kdw
from .block import (GATE_FUSED_MAX_C, _mm, _st, _vjp_plain, _vjp_widened, _wide, _workspaces,
                    gate_ld, ln_plan, split_plan, sum_plan, sum_workspace_numel)
from .conv import conv1x1, depthwise3x3
from .gdfn import gated
from .gram import sm_count


# ------------------------------------------------------------------ plain

def fused_dwconv_plain(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                       w_out: Optional[torch.Tensor]) -> torch.Tensor:
    """w_out None: the qkv configuration, h and the output rounded to x's
    dtype (no rounding in fp32); else the GDFN (gate, then W_out)."""
    h = depthwise3x3(_wide(_mm(x, w_in)), _wide(dwk))
    return h.to(x.dtype) if w_out is None else conv1x1(gated(h), w_out)


def _qkv_rounded(dtype, x, w_in, dwk):
    """The qkv configuration in fp32 as the JAX backward kernel recomputes
    and differentiates it: h rounded to dtype, the stencil fp32."""
    return depthwise3x3(_st(conv1x1(x, w_in), dtype), dwk)


def fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g):
    """-> (dx, dw_in, ddw, dw_out); dw_out is None when w_out is. On bf16
    (the qkv configuration) as the JAX backward kernel computes it."""
    if x.dtype == torch.bfloat16 and w_out is None:
        return (*_vjp_widened(functools.partial(_qkv_rounded, x.dtype), (x, w_in, dwk), g),
                None)
    return _vjp_plain(fused_dwconv_plain, (x, w_in, dwk, w_out), g)


# ------------------------------------------------------------------ plans

# The launch plans of csrc/fused_dwconv.cu, pure functions of the shape,
# the copy widths and the card, made as ops/block.py makes the block
# kernels' (the same products, pixel sums, gate and depthwise kernels): the
# K splits of the per-pixel products (split_plan: h and the GDFN's W_out
# product forward, h and dx backward), the pixel ranges of the pixel sums
# (sum_plan: dW_out and dW_in), row 11's (vec, cv, tc, rows) of the
# depthwise forward (also the rotated one) and of its dtaps, and, in the
# GDFN forward, the gate taken in the W_out product where C <=
# GATE_FUSED_MAX_C, else a gate pass of ln_plan's blocks. Each is passed as
# FWD_PLAN_INTS or BWD_PLAN_INTS ints, the order of its fields. Copy widths
# come in width classes: C (x, W_in, the GDFN's g), h (either half of
# conv, W_out's rows, the gate) and M (h, dh, dconv, the qkv's g and out);
# the workspaces start on 512-byte boundaries (ops/block.py _workspaces),
# so only their widths decide their copies.
FWD_PLAN_INTS = 13
BWD_PLAN_INTS = 21


class FusedFwdPlan(NamedTuple):
    """A forward's launch plan; `ints()` is what the kernel takes."""
    gate_blocks: int                     # blocks of a gate pass
    vec_c: int                           # copy widths of the C- and h-wide operands
    vec_h: int
    vec_g: int                           # ... and of a gate pass's padded rows
    splits: Tuple[Tuple[int, int], ...]  # (K ranges, depth a range) of h, out
    dw_conv: Tuple[int, int, int, int]   # (vec, cv, tc, rows) of the depthwise forward
    gate_pass: int                       # 1: the gate as a pass of its own
    sums_numel: int                      # floats of the split partials' workspace

    def ints(self) -> Tuple[int, ...]:
        out = (self.gate_blocks, self.vec_c, self.vec_h, self.vec_g,
               *(k for split in self.splits for k in split), *self.dw_conv, self.gate_pass)
        assert len(out) == FWD_PLAN_INTS
        return out


class FusedBwdPlan(NamedTuple):
    """A backward's launch plan; `ints()` is what the kernel takes."""
    sum_per: Tuple[int, int]             # pixels a range: dW_out (0 in qkv), dW_in
    vec_c: int                           # copy widths of the C-, h- and M-wide operands
    vec_h: int
    vec_m: int
    splits: Tuple[Tuple[int, int], ...]  # (K ranges, depth a range) of h, dx
    dw_conv: Tuple[int, int, int, int]   # (vec, cv, tc, rows) of the depthwise forward
    dw_rot: Tuple[int, int, int, int]    # ... its rotated forward (dh)
    dw_taps: Tuple[int, int, int, int]   # ... its dtaps
    sums_numel: int                      # floats of the sums workspace

    def ints(self) -> Tuple[int, ...]:
        out = (*self.sum_per, self.vec_c, self.vec_h, self.vec_m,
               *(k for split in self.splits for k in split), *self.dw_conv,
               *self.dw_rot, *self.dw_taps)
        assert len(out) == BWD_PLAN_INTS
        return out


def _splits(pixels: int, prods, n_sm: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((1, 0) if nk is None else split_plan(pixels, *nk, n_sm) for nk in prods)


def fused_fwd_plan(b: int, h: int, w: int, c: int, width: int, gdfn: bool, n_sm: int,
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int]
                   ) -> FusedFwdPlan:
    """The plan of a forward on (B,H,W,C) with depthwise width `width` (2h
    in the GDFN, M in the qkv configuration) on a card of n_sm SMs; vecs the
    copy widths of the C class, the h class and a gate pass's rows, dw_conv
    row 11's (vec, cv, tc, rows) on (B,H,W,width)."""
    n = b * h * w
    # (n, k) of h and out (None: not run)
    prods = ((width, c), (c, width // 2) if gdfn else None)
    splits = _splits(n, prods, n_sm)
    numel = max([0] + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1])
    return FusedFwdPlan(ln_plan(n, n_sm)[0], *vecs, splits, dw_conv,
                        int(gdfn and c > GATE_FUSED_MAX_C), numel)


def fused_bwd_plan(b: int, h: int, w: int, c: int, width: int, gdfn: bool, n_sm: int,
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int],
                   dw_taps: Tuple[int, int, int, int]) -> FusedBwdPlan:
    """The plan of a backward on (B,H,W,C) with depthwise width `width` on a
    card of n_sm SMs; vecs the copy widths of the C, h and M classes,
    dw_conv and dw_taps row 11's (vec, cv, tc, rows) on (B,H,W,width) for
    its forward (and rotated forward) and its dtaps."""
    n = b * h * w
    # (m, n) of the pixel sums dW_out and dW_in; (n, k) of the products h, dx
    sums = ((c, width // 2) if gdfn else None, (width, c))
    prods = ((width, c), (c, width))
    splits = _splits(n, prods, n_sm)
    numel = max([sum_workspace_numel(m, k, n, n_sm) for m, k in filter(None, sums)]
                + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1]
                + [kdw.dtaps_workspace_numel(b, h, w, width, dw_taps[2], dw_taps[3])])
    per = tuple(0 if mk is None else sum_plan(*mk, n, n_sm)[1] for mk in sums)
    return FusedBwdPlan(per, *vecs, splits, dw_conv if gdfn else (0, 0, 0, 0), dw_conv,
                        dw_taps, numel)


def fwd_workspace_numel(n: int, width: int, gdfn: bool) -> Tuple[int, ...]:
    """Floats of each workspace of a forward on n pixels, in the order the
    kernel takes them: the GDFN's h (which takes the gate of a gate pass, n
    rows of gate_ld(h)) and conv, the qkv configuration's h."""
    if gdfn:
        return n * max(width, gate_ld(width // 2)), n * width
    return (n * width,)


def bwd_workspace_numel(n: int, width: int, gdfn: bool) -> Tuple[int, ...]:
    """Floats of each workspace of a backward on n pixels, in the order the
    kernel takes them: the GDFN's h, conv (then dh), dconv and gate, the qkv
    configuration's h and dh."""
    if gdfn:
        return n * width, n * width, n * width, n * (width // 2)
    return n * width, n * width


def fused_vecs(c: int, width: int, gdfn: bool, ptrs: dict) -> Tuple[int, int, int, int]:
    """-> copy widths of the C class, the h class, a gate pass's rows and the
    M class of a call whose operands start at ptrs (name -> address; the
    workspaces start on 512-byte boundaries): x, w_in and, in the GDFN,
    w_out and, where they are C- or M-wide operands, g and out."""
    if gdfn:  # g is C-wide; y leaves through the product's epilogue, not by copies
        hid = width // 2
        g = [ptrs["g"]] if "g" in ptrs else []
        return (kdw.dwconv_vec(c, ptrs["x"], ptrs["w_in"], *g),
                kdw.dwconv_vec(hid, ptrs["w_out"]), kdw.dwconv_vec(gate_ld(hid)),
                kdw.dwconv_vec(width))
    m_wide = [ptrs[k] for k in ("g", "out") if k in ptrs]
    return kdw.dwconv_vec(c, ptrs["x"], ptrs["w_in"]), 1, 1, kdw.dwconv_vec(width, *m_wide)


@functools.lru_cache(maxsize=None)
def _fwd_card_plan(b, h, w, c, width, gdfn, device_index, vec_c, vec_h, vec_g, vec_m,
                   io="f32"):
    """-> (the forward plan's ints as a ctypes array, floats of sums) on this
    card; io the depthwise forward's element types (ops/dwconv.py DW_IO)."""
    dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False, io))
    plan = fused_fwd_plan(b, h, w, c, width, gdfn, sm_count(device_index),
                          (vec_c, vec_h, vec_g), dw_conv)
    return (ctypes.c_int * FWD_PLAN_INTS)(*plan.ints()), plan.sums_numel


@functools.lru_cache(maxsize=None)
def _bwd_card_plan(b, h, w, c, width, gdfn, device_index, vec_c, vec_h, vec_m):
    """-> (the backward plan's ints as a ctypes array, floats of sums) on this card."""
    dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False))
    dw_taps = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, True))
    plan = fused_bwd_plan(b, h, w, c, width, gdfn, sm_count(device_index),
                          (vec_c, vec_h, vec_m), dw_conv, dw_taps)
    return (ctypes.c_int * BWD_PLAN_INTS)(*plan.ints()), plan.sums_numel


# ---------------------------------------------------------------- kernels

def _refuse_bf16_gdfn(x, w_out) -> None:
    if x.dtype == torch.bfloat16 and w_out is not None:
        raise NotImplementedError(
            "gdfn_fused in bf16 (bf16 training in `--composition head` or `off`) is not "
            "ported yet (ROADMAP Queue 1 item 4)")


def _check(x, w_in, dwk, w_out, g=None):
    b, h, w, c = x.shape
    m = w_in.shape[0]
    dev = x.device
    dt = build.kernel_dtype(x)
    build.check_arg("x", x, (b, h, w, c), dev, dt)
    build.check_arg("w_in", w_in, (m, c), dev, dt)
    build.check_arg("dwk", dwk, (m, 3, 3), dev, dt)
    if w_out is not None:
        if m % 2:
            raise ValueError(f"the gate needs an even width, got {m}")
        build.check_arg("w_out", w_out, (c, m // 2), dev, dt)
    build.check_arg("g", g, (b, h, w, m if w_out is None else c), dev, dt)
    return b, h, w, c, m


def fused_dwconv_fwd(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                     w_out: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,H,W,C) -> (B,H,W,M) without w_out, (B,H,W,C) with it, in x's
    dtype (fp32, or bf16 without w_out). On the card two calls on the same
    inputs give the same bits."""
    _refuse_bf16_gdfn(x, w_out)
    if not x.is_cuda:
        return fused_dwconv_plain(x, w_in, dwk, w_out)
    if x.dtype == torch.bfloat16:
        return _conv1x1_dw_bf16(x, w_in, dwk)
    b, h, w, c, m = _check(x, w_in, dwk, w_out)
    gdfn = w_out is not None
    dev = x.device
    out = torch.empty(b, h, w, c if gdfn else m, device=dev)
    ptrs = {"x": x.data_ptr(), "w_in": w_in.data_ptr(), "w_out": build.ptr(w_out),
            "out": out.data_ptr()}
    plan, n_sums = _fwd_card_plan(b, h, w, c, m, gdfn, dev.index,
                                  *fused_vecs(c, m, gdfn, ptrs))
    buf, ws = _workspaces(dev, (*fwd_workspace_numel(b * h * w, m, gdfn), n_sums))
    name = "gdfn_fused" if gdfn else "conv1x1_dw"
    with torch.cuda.device(dev):
        build.call(f"rcot_{name}", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   *((w_out.data_ptr(),) if gdfn else ()), out.data_ptr(), *ws, plan,
                   b, h, w, c, m // 2 if gdfn else m, build.stream())
    build.LAUNCHES[name] += 1
    return out


def fused_dwconv_bwd(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                     w_out: Optional[torch.Tensor], g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Backward of fused_dwconv_fwd for the cotangent g ->
    (dx, dw_in, ddw, dw_out); dw_out is None when w_out is. On the card
    every sum runs in a fixed order, so two calls on the same inputs give
    the same bits; in x's dtype."""
    _refuse_bf16_gdfn(x, w_out)
    if not x.is_cuda:
        return fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g)
    if x.dtype == torch.bfloat16:
        return (*_conv1x1_dw_bwd_bf16(x, w_in, dwk, g), None)
    b, h, w, c, m = _check(x, w_in, dwk, w_out, g)
    gdfn = w_out is not None
    dev = x.device
    dx, dw_in, ddw = (torch.empty_like(t) for t in (x, w_in, dwk))
    dw_out = torch.empty_like(w_out) if gdfn else None
    ptrs = {"x": x.data_ptr(), "w_in": w_in.data_ptr(), "w_out": build.ptr(w_out),
            "g": g.data_ptr()}
    vec_c, vec_h, _, vec_m = fused_vecs(c, m, gdfn, ptrs)
    plan, n_sums = _bwd_card_plan(b, h, w, c, m, gdfn, dev.index, vec_c, vec_h, vec_m)
    buf, ws = _workspaces(dev, (*bwd_workspace_numel(b * h * w, m, gdfn), n_sums))
    name = "gdfn_fused_bwd" if gdfn else "conv1x1_dw_bwd"
    with torch.cuda.device(dev):
        build.call(f"rcot_{name}", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   *((w_out.data_ptr(),) if gdfn else ()), g.data_ptr(), dx.data_ptr(),
                   dw_in.data_ptr(), ddw.data_ptr(), *((dw_out.data_ptr(),) if gdfn else ()),
                   *ws, plan, b, h, w, c, m // 2 if gdfn else m, build.stream())
    build.LAUNCHES[name] += 1
    return dx, dw_in, ddw, dw_out


def _conv1x1_dw_bf16(x, w_in, dwk):
    """The qkv forward on bf16 CUDA tensors: csrc/fused_dwconv_bf16.cu,
    with fused_fwd_plan's plan in bf16 copy widths."""
    b, h, w, c, m = _check(x, w_in, dwk, None)
    dev = x.device
    out = torch.empty(b, h, w, m, device=dev, dtype=torch.bfloat16)
    buf, (hbuf,) = _workspaces(dev, (-(-b * h * w * m // 2),))
    vec_c = kdw.bf16_vec(c, x.data_ptr(), w_in.data_ptr())
    vec_m = kdw.bf16_vec(m, hbuf, out.data_ptr())
    if vec_m < 2:
        raise ValueError(f"bf16 conv1x1_dw: the width {m} must be even "
                         "(its depthwise copies move two bf16 at least)")
    plan, n_sums = _fwd_card_plan(b, h, w, c, m, False, dev.index, vec_c, 1, 1, vec_m, "bf16")
    sums = torch.empty(n_sums, device=dev) if n_sums else None
    with torch.cuda.device(dev):
        build.call("rcot_conv1x1_dw_bf16", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   out.data_ptr(), hbuf, build.ptr(sums), plan, b, h, w, c, m, build.stream())
    build.LAUNCHES["conv1x1_dw_bf16"] += 1
    return out


def _conv1x1_dw_bwd_bf16(x, w_in, dwk, g):
    """The qkv backward on bf16 CUDA tensors -> (dx, dw_in, ddw), bf16:
    csrc/fused_dwconv_bf16.cu, with fused_bwd_plan's plan on its fp32
    workspaces."""
    b, h, w, c, m = _check(x, w_in, dwk, None, g)
    dev = x.device
    n = b * h * w
    dx, dw_in, ddw = (torch.empty_like(t) for t in (x, w_in, dwk))
    # hb (bf16); x32, g32, h32, dh, dx32, w32, dwk32, dw_in32, ddw32
    buf, ws = _workspaces(dev, (-(-n * m // 2), n * c, n * m, n * m, n * m, n * c, m * c,
                                9 * m, m * c, 9 * m))
    vec_c = kdw.dwconv_vec(c, ws[1], ws[5], ws[6])
    vec_m = kdw.dwconv_vec(m, ws[2], ws[3], ws[4])
    plan, n_sums = _bwd_card_plan(b, h, w, c, m, False, dev.index, vec_c, 1, vec_m)
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_conv1x1_dw_bwd_bf16", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), dw_in.data_ptr(), ddw.data_ptr(), *ws,
                   sums.data_ptr(), plan, kdw.bf16_vec(c, x.data_ptr(), w_in.data_ptr()),
                   b, h, w, c, m, build.stream())
    build.LAUNCHES["conv1x1_dw_bwd_bf16"] += 1
    return dx, dw_in, ddw


# --------------------------------------------------------------- autograd

class FusedDwconv(torch.autograd.Function):
    """fused_dwconv_fwd with its backward kernel; saves only x and the
    weights (pallas_fused.py _vjp_fwd)."""

    @staticmethod
    def forward(ctx, x, w_in, dwk, w_out):
        ctx.save_for_backward(x, w_in, dwk, w_out)
        return fused_dwconv_fwd(x, w_in, dwk, w_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.cat's backward arrives here
        return fused_dwconv_bwd(*ctx.saved_tensors, g.contiguous())


def conv1x1_dw_fused(x: torch.Tensor, w_in: torch.Tensor,
                     dwk: torch.Tensor) -> torch.Tensor:
    """1x1 conv then its depthwise 3x3, differentiable: x (B,H,W,C) ->
    (B,H,W,M); w_in (M,C), dwk (M,3,3). The MDTA qkv path."""
    return FusedDwconv.apply(x, w_in, dwk, None)


def gdfn_fused(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """The whole bias-free GDFN, differentiable: x (B,H,W,C) -> (B,H,W,C);
    w_in (2h,C), dwk (2h,3,3), w_out (C,h)."""
    return FusedDwconv.apply(x, w_in, dwk, w_out)
