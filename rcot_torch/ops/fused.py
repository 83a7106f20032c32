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

bf16 (the qkv configuration in bf16 training's "tail" and "off", the GDFN
in bf16 serving and training's "head" and "off"): a bf16 x with bf16
weights goes to csrc/fused_dwconv_bf16.cu on the card, counted as
conv1x1_dw_bf16, gdfn_fused_bf16 and their *_bwd_bf16 names (both
backwards run fused_dwconv.cu's design on the bf16 tensors themselves, with
fused_bwd_plan's plan and a second of their bf16 pieces: ops/block.py
qkv_bwd_bf16_plan for the qkv's, gated_bwd_bf16_plan with the copy widths
of gated_bf16_vecs for the GDFN's; the qkv forward is one launch of the
product-depthwise, csrc/pw_dw.cu, with no h in device memory; the GDFN
forward takes its gate in its depthwise, with no fp32 conv in device
memory). The forward twin rounds h, the
GDFN's gate and the output to bf16 where the JAX kernel
does (pallas_fused.py:153-183); the backward twin is the JAX backward
kernel's (:297-412): h recomputed and rounded, then everything in fp32
(dW_out from the unrounded gate), each grad rounded once (ops/block.py
_vjp_widened).

bf16 operands (the JAX package's RCOT_BWD_BF16 "fused" tier, the default
tier of pallas_fused.py's _bwd_dot): with bf16_ops the backward's products
(dgate, dx, dW_in, dW_out) round both operands to bf16 and sum in fp32,
in fp32 and in bf16 alike; on the card the kernels' `ops16` form, counted
under the backward's name with _b16ops after it (ops/block.py says more).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import dwconv as kdw
from .block import (GATE_FUSED_MAX_C, _gated_bwd_bf16_card_plan, _mm, _prod,
                    _qkv_bwd_bf16_card_plan, _st, _vjp_plain, _vjp_widened, _wide, _workspaces,
                    gate_ld, gated_bf16_vecs, ln_plan, pw_card_plan, split_plan, sum_plan,
                    sum_workspace_numel)
from .conv import conv1x1, depthwise3x3  # noqa: F401 (conv1x1: _prod's product, re-exported)
from .gdfn import gated
from .gram import sm_count


# ------------------------------------------------------------------ plain

def fused_dwconv_plain(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                       w_out: Optional[torch.Tensor], bf16_ops: bool = False) -> torch.Tensor:
    """w_out None: the qkv configuration, h and the output rounded to x's
    dtype (no rounding in fp32); else the GDFN, h, the gate and the output
    rounded to x's dtype, the stencil and the gate in at least fp32;
    bf16_ops: the products' backward on bf16 operands."""
    h = depthwise3x3(_wide(_mm(x, w_in, bf16_ops)), _wide(dwk))
    return h.to(x.dtype) if w_out is None else _mm(gated(h).to(x.dtype), w_out, bf16_ops)


def _qkv_rounded(dtype, x, w_in, dwk, bf16_ops=False):
    """The qkv configuration in fp32 as the JAX backward kernel recomputes
    and differentiates it: h rounded to dtype, the stencil fp32."""
    return depthwise3x3(_st(_prod(x, w_in, bf16_ops), dtype), dwk)


def _gdfn_rounded(dtype, x, w_in, dwk, w_out, bf16_ops=False):
    """The GDFN in fp32 as the JAX backward kernel recomputes and
    differentiates it (pallas_fused.py:330-412): h rounded to dtype; conv,
    the gate (dW_out takes it unrounded) and the rest fp32."""
    return _prod(gated(_qkv_rounded(dtype, x, w_in, dwk, bf16_ops)), w_out, bf16_ops)


def fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g, bf16_ops=False):
    """-> (dx, dw_in, ddw, dw_out); dw_out is None when w_out is. On bf16
    as the JAX backward kernel computes it; bf16_ops: the products on bf16
    operands."""
    if x.dtype != torch.bfloat16:
        return _vjp_plain(functools.partial(fused_dwconv_plain, bf16_ops=bf16_ops),
                          (x, w_in, dwk, w_out), g)
    if w_out is None:
        return (*_vjp_widened(functools.partial(_qkv_rounded, x.dtype, bf16_ops=bf16_ops),
                              (x, w_in, dwk), g), None)
    return _vjp_widened(functools.partial(_gdfn_rounded, x.dtype, bf16_ops=bf16_ops),
                        (x, w_in, dwk, w_out), g)


# ------------------------------------------------------------------ plans

# The launch plans of csrc/fused_dwconv.cu, pure functions of the shape,
# the copy widths and the card, made as ops/block.py makes the block
# kernels' (the same products, pixel sums, gate and depthwise kernels): the
# K splits of the per-pixel products (split_plan: h and the GDFN's W_out
# product forward, h and dx backward), the pixel ranges of the pixel sums
# (sum_plan: dW_out and dW_in), row 11's (vec, cv, tc, rows) of the
# depthwise forward (also the rotated one) and of its dtaps, and, in the
# GDFN forward, the gate taken in the W_out product where C <=
# GATE_FUSED_MAX_C, else a gate pass of ln_plan's blocks (in bf16, in the
# gated depthwise: kdw.conv_gate_plan's plan). Each is passed as
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
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int],
                   bf16: bool = False) -> FusedFwdPlan:
    """The plan of a forward on (B,H,W,C) with depthwise width `width` (2h
    in the GDFN, M in the qkv configuration) on a card of n_sm SMs; vecs the
    copy widths of the C class, the h class and a gate pass's rows, dw_conv
    row 11's (vec, cv, tc, rows) on (B,H,W,width) (the bf16 GDFN's the gated
    depthwise's, kdw.conv_gate_plan); bf16 the bf16 kernels' (the GDFN's
    gate taken in its depthwise, as ops/block.py's bf16 tail: no gate
    pass)."""
    n = b * h * w
    # (n, k) of h and out (None: not run)
    prods = ((width, c), (c, width // 2) if gdfn else None)
    splits = _splits(n, prods, n_sm)
    numel = max([0] + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1])
    return FusedFwdPlan(ln_plan(n, n_sm)[0], *vecs, splits, dw_conv,
                        int(gdfn and not bf16 and c > GATE_FUSED_MAX_C), numel)


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
    card; io the depthwise forward's element types (ops/dwconv.py DW_IO), or
    "gate" for the bf16 GDFN's gated depthwise (kdw.conv_gate_plan)."""
    if io == "gate":
        dw_conv = kdw.conv_gate_plan(b, h, w, width // 2, sm_count(device_index))
    else:
        dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False, io))
    plan = fused_fwd_plan(b, h, w, c, width, gdfn, sm_count(device_index),
                          (vec_c, vec_h, vec_g), dw_conv, io != "f32")
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
    dtype (fp32 or bf16). On the card two calls on the same inputs give the
    same bits."""
    if not x.is_cuda:
        return fused_dwconv_plain(x, w_in, dwk, w_out)
    if x.dtype == torch.bfloat16:
        return _conv1x1_dw_bf16(x, w_in, dwk) if w_out is None else _gdfn_fused_bf16(
            x, w_in, dwk, w_out)
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
                     w_out: Optional[torch.Tensor], g: torch.Tensor, bf16_ops: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Backward of fused_dwconv_fwd for the cotangent g ->
    (dx, dw_in, ddw, dw_out); dw_out is None when w_out is; bf16_ops: its
    products on bf16 operands (module docstring). On the card every sum
    runs in a fixed order, so two calls on the same inputs give the same
    bits; in x's dtype."""
    if not x.is_cuda:
        return fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g, bf16_ops)
    if x.dtype == torch.bfloat16:
        if w_out is None:
            return (*_conv1x1_dw_bwd_bf16(x, w_in, dwk, g, bf16_ops), None)
        return _gdfn_fused_bwd_bf16(x, w_in, dwk, w_out, g, bf16_ops)
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
                   *ws, plan, b, h, w, c, m // 2 if gdfn else m, int(bf16_ops), build.stream())
    build.LAUNCHES[build.counted(name, bf16_ops)] += 1
    return dx, dw_in, ddw, dw_out


def _conv1x1_dw_bf16(x, w_in, dwk, launches: bool = False):
    """The qkv forward on bf16 CUDA tensors (csrc/fused_dwconv_bf16.cu): one
    launch of the product-depthwise (csrc/pw_dw.cu, its plan
    ops/block.py pw_card_plan), which keeps h in the SM: no workspace. With
    `launches`, or where C passes the product-depthwise's shared memory, the
    bf16 product and the depthwise in launches of their own through h in
    device memory (fused_fwd_plan's plan in bf16 copy widths; the same
    bits)."""
    b, h, w, c, m = _check(x, w_in, dwk, None)
    dev = x.device
    out = torch.empty(b, h, w, m, device=dev, dtype=torch.bfloat16)
    vec_c = kdw.bf16_vec(c, x.data_ptr(), w_in.data_ptr())
    if kdw.bf16_vec(m, out.data_ptr()) < 2:
        raise ValueError(f"bf16 conv1x1_dw: the width {m} must be even "
                         "(its depthwise copies move two bf16 at least)")
    pw = None if launches else pw_card_plan(b, h, w, c, m, dev.index, vec_c,
                                            kdw.bf16_vec(m, out.data_ptr()))
    hbuf, plan, sums = 0, None, None
    if pw is None:
        buf, (hbuf,) = _workspaces(dev, (-(-b * h * w * m // 2),))
        vec_m = kdw.bf16_vec(m, hbuf, out.data_ptr())
        plan, n_sums = _fwd_card_plan(b, h, w, c, m, False, dev.index, vec_c, 1, 1, vec_m,
                                      "bf16")
        sums = torch.empty(n_sums, device=dev) if n_sums else None
    with torch.cuda.device(dev):
        build.call("rcot_conv1x1_dw_bf16", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   out.data_ptr(), hbuf, build.ptr(sums), plan, pw, b, h, w, c, m,
                   build.stream())
    build.LAUNCHES["conv1x1_dw_bf16"] += 1
    return out


def qkv_bwd_bf16_workspace_numel(n: int, m: int) -> Tuple[int, int]:
    """Floats of each workspace of the bf16 qkv backward on n pixels, in
    the order csrc/fused_dwconv_bf16.cu takes them: the recomputed h (bf16,
    two to a float) and dh (fp32). No fp32 copy of an operand."""
    return -(-n * m // 2), n * m


def _conv1x1_dw_bwd_bf16(x, w_in, dwk, g, bf16_ops):
    """The qkv backward on bf16 CUDA tensors -> (dx, dw_in, ddw), bf16:
    csrc/fused_dwconv_bf16.cu, fused_dwconv.cu's design on the bf16 tensors
    themselves, with fused_bwd_plan's plan of that design and a second of
    its bf16 pieces (ops/block.py qkv_bwd_bf16_plan)."""
    b, h, w, c, m = _check(x, w_in, dwk, None, g)
    dev = x.device
    n = b * h * w
    dx, dw_in, ddw = (torch.empty_like(t) for t in (x, w_in, dwk))
    buf, (hbuf, dh) = _workspaces(dev, qkv_bwd_bf16_workspace_numel(n, m))
    # the fp32 design's plan: its copy widths those of the fp32 operands
    vec_m32 = kdw.dwconv_vec(m, dh)
    plan, n_sums = _bwd_card_plan(b, h, w, c, m, False, dev.index, kdw.dwconv_vec(c), 1,
                                  vec_m32)
    plan16 = _qkv_bwd_bf16_card_plan(b, h, w, c, m, dev.index,
                                     kdw.bf16_vec(c, x.data_ptr(), w_in.data_ptr()),
                                     kdw.bf16_vec(m, hbuf, g.data_ptr()), vec_m32)
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_conv1x1_dw_bwd_bf16", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), dw_in.data_ptr(), ddw.data_ptr(), hbuf, dh,
                   sums.data_ptr(), plan, plan16, b, h, w, c, m, int(bf16_ops), build.stream())
    build.LAUNCHES[build.counted("conv1x1_dw_bwd_bf16", bf16_ops)] += 1
    return dx, dw_in, ddw


def gdfn_fwd_bf16_workspace_numel(n: int, hid: int) -> Tuple[int, int]:
    """Floats of each workspace of the bf16 GDFN forward on n pixels, in the
    order csrc/fused_dwconv_bf16.cu takes them: h (n x 2 hid) and the gate
    (n rows of gate_ld(hid, bf16)), bf16, two to a float. No fp32 conv: the
    gated depthwise keeps it in registers."""
    return -(-n * 2 * hid // 2), -(-n * gate_ld(hid, True) // 2)


def _gdfn_fused_bf16(x, w_in, dwk, w_out):
    """The GDFN forward on bf16 CUDA tensors: csrc/fused_dwconv_bf16.cu, with
    fused_fwd_plan's plan in bf16 copy widths, its gate taken in its
    depthwise (kdw.conv_gate_plan)."""
    b, h, w, c, m = _check(x, w_in, dwk, w_out)
    hid = m // 2
    dev = x.device
    n = b * h * w
    y = torch.empty_like(x)
    buf, (hbuf, gate) = _workspaces(dev, gdfn_fwd_bf16_workspace_numel(n, hid))
    vecs = (kdw.bf16_vec(c, x.data_ptr(), w_in.data_ptr()), kdw.bf16_vec(hid, w_out.data_ptr()),
            kdw.bf16_vec(gate_ld(hid, True), gate), kdw.conv_gate_vec(hid, hbuf))
    plan, n_sums = _fwd_card_plan(b, h, w, c, m, True, dev.index, *vecs, "gate")
    sums = torch.empty(n_sums, device=dev) if n_sums else None
    with torch.cuda.device(dev):
        build.call("rcot_gdfn_fused_bf16", x.data_ptr(), w_in.data_ptr(), dwk.data_ptr(),
                   w_out.data_ptr(), y.data_ptr(), hbuf, gate, build.ptr(sums), plan,
                   b, h, w, c, hid, build.stream())
    build.LAUNCHES["gdfn_fused_bf16"] += 1
    return y


def gdfn_bwd_bf16_workspace_numel(n: int, c: int, hid: int) -> Tuple[int, ...]:
    """Floats of each workspace of the bf16 GDFN backward on n pixels, in the
    order csrc/fused_dwconv_bf16.cu takes them: the recomputed h (bf16, two
    to a float); conv (then dh), dconv and the gate (fp32). No fp32 copy of
    an operand: its products and stencils read the bf16 tensors as they
    are."""
    m = 2 * hid
    return -(-n * m // 2), n * m, n * m, n * hid


def _gdfn_fused_bwd_bf16(x, w_in, dwk, w_out, g, bf16_ops):
    """The GDFN backward on bf16 CUDA tensors -> (dx, dw_in, ddw, dw_out),
    bf16: csrc/fused_dwconv_bf16.cu, fused_dwconv.cu's design on the bf16
    tensors themselves, with fused_bwd_plan's plan of that design and a
    second of its bf16 pieces (ops/block.py gated_bwd_bf16_plan)."""
    b, h, w, c, m = _check(x, w_in, dwk, w_out, g)
    hid = m // 2
    dev = x.device
    dx, dw_in, ddw, dw_out = (torch.empty_like(t) for t in (x, w_in, dwk, w_out))
    buf, ws = _workspaces(dev, gdfn_bwd_bf16_workspace_numel(b * h * w, c, hid))
    hbuf, conv_dh, dconv, gate = ws
    # the fp32 design's plan: its copy widths those of the fp32 operands
    plan, n_sums = _bwd_card_plan(b, h, w, c, m, True, dev.index, kdw.dwconv_vec(c),
                                  kdw.dwconv_vec(hid, gate), kdw.dwconv_vec(m, conv_dh, dconv))
    plan16 = _gated_bwd_bf16_card_plan(
        b, h, w, c, m, dev.index,
        *gated_bf16_vecs(c, hid, (x.data_ptr(), w_in.data_ptr()), g.data_ptr(),
                         w_out.data_ptr(), hbuf, conv_dh))
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_gdfn_fused_bwd_bf16",
                   *(t.data_ptr() for t in (x, w_in, dwk, w_out, g, dx, dw_in, ddw, dw_out)),
                   *ws, sums.data_ptr(), plan, plan16, b, h, w, c, hid, int(bf16_ops),
                   build.stream())
    build.LAUNCHES[build.counted("gdfn_fused_bwd_bf16", bf16_ops)] += 1
    return dx, dw_in, ddw, dw_out


# --------------------------------------------------------------- autograd

class FusedDwconv(torch.autograd.Function):
    """fused_dwconv_fwd with its backward kernel; saves only x and the
    weights (pallas_fused.py _vjp_fwd); bf16_ops (not a tensor) picks the
    backward's operand form."""

    @staticmethod
    def forward(ctx, x, w_in, dwk, w_out, bf16_ops):
        ctx.save_for_backward(x, w_in, dwk, w_out)
        ctx.bf16_ops = bf16_ops
        return fused_dwconv_fwd(x, w_in, dwk, w_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.cat's backward arrives here
        return (*fused_dwconv_bwd(*ctx.saved_tensors, g.contiguous(), ctx.bf16_ops), None)


def conv1x1_dw_fused(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                     bf16_ops: bool = False) -> torch.Tensor:
    """1x1 conv then its depthwise 3x3, differentiable: x (B,H,W,C) ->
    (B,H,W,M); w_in (M,C), dwk (M,3,3). The MDTA qkv path. bf16_ops: the
    backward's products on bf16 operands (RCOT_BWD_BF16's "fused")."""
    return FusedDwconv.apply(x, w_in, dwk, None, bf16_ops)


def gdfn_fused(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
               w_out: torch.Tensor, bf16_ops: bool = False) -> torch.Tensor:
    """The whole bias-free GDFN, differentiable: x (B,H,W,C) -> (B,H,W,C);
    w_in (2h,C), dwk (2h,3,3), w_out (C,h); bf16_ops as conv1x1_dw_fused's."""
    return FusedDwconv.apply(x, w_in, dwk, w_out, bf16_ops)
