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

bf16: a bf16 x with bf16 weights (LN weights fp32, as
rcot_tpu/models/restormer.py:77-89 passes them) goes to the bf16 kernels of
csrc/block_fwd_bf16.cu on the card, counted as block_head_bf16 and
block_tail_bf16 (the head its LayerNorm and then one launch of the
product-depthwise, csrc/pw_dw.cu, its plan ops/dwconv.py pw_dw_plan: h never
reaches device memory; the tail's gate taken in its depthwise, ops/dwconv.py
conv_gate_plan: no gate pass, no fp32 conv), and their backwards (bf16
training: the tail in "tail" and "full", the head in "full" and "head") to
csrc/block_bwd_bf16.cu,
counted as block_tail_bwd_bf16 and block_head_bwd_bf16; both run
block_bwd.cu's design on the bf16 tensors themselves (block_bwd_plan's plan
and a second of their bf16 pieces: the tail's gated_bwd_bf16_plan with the
copy widths of gated_bf16_vecs, the head's qkv_bwd_bf16_plan). The plain forward
twins take any float dtype: their products and stencils
run in at least fp32 and round to x's dtype where the JAX kernel
(rcot_tpu/ops/pallas_block.py:111-142) rounds, which in fp32 or float64 is
no rounding at all. The bf16 backward twin is not autograd through them:
the JAX backward kernel (:208-397) recomputes the forward with its
rounding points but differentiates it in fp32, with fp32 cotangents and
the unrounded gate (_vjp_widened).

bf16 operands (the JAX package's RCOT_BWD_BF16 "block" tier,
pallas_block.py's _bwd_dot(..., tier="block")): with bf16_ops the backward
rounds both operands of each of its products (dgate, du, da and the pixel
sums dW_out, dW_in, dW_proj, dW_qkv) to bf16 and sums in fp32; the
recompute, the LayerNorm backward, the residual and the taps' gradient stay
as they were. On the card that is the kernels' `ops16` form (csrc/mm.cuh
OPS16), counted under the backward's name with _b16ops after it; the twins
take each 1x1 product through _Mm16, whose backward does the same.
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
from .gram import GRAM_MAX_PIXELS, _cdiv, _r16, sm_count
from .layernorm import layernorm


# ------------------------------------------------------------------ plain

def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in at least fp32 (a float64 twin stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class _Mm16(torch.autograd.Function):
    """The 1x1 product a @ w^T (conv1x1) whose backward takes bf16
    operands: both operands of each of its two products, da = g w and
    dw = g^T a, rounded to bf16 and summed in the working dtype, as the JAX
    backward kernels' _bwd_dot under RCOT_BWD_BF16
    (rcot_tpu/ops/pallas_fused.py:144-148)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return conv1x1(a, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g16 = _r16(g)
        da = g16 @ _r16(w.reshape(w.shape[0], -1))
        dw = g16.reshape(-1, g.shape[-1]).t() @ _r16(a).reshape(-1, a.shape[-1])
        return da, dw.reshape(w.shape)


def _prod(a: torch.Tensor, w: torch.Tensor, bf16_ops: bool = False) -> torch.Tensor:
    """conv1x1(a, w), through _Mm16 with bf16_ops."""
    return _Mm16.apply(a, w) if bf16_ops else conv1x1(a, w)


def _mm(a: torch.Tensor, w: torch.Tensor, bf16_ops: bool = False) -> torch.Tensor:
    """The 1x1 product a @ w^T in at least fp32, rounded to a's dtype; its
    backward on bf16 operands with bf16_ops."""
    return _prod(_wide(a), _wide(w), bf16_ops).to(a.dtype)


def block_head_plain(x, ln_w, ln_b, w_qkv, dwk, bf16_ops=False):
    """qkv = dw3x3(LN1(x) @ W_qkv), rounded to x's dtype after the LN, the
    product and the stencil (pallas_block.py:119-142); bf16_ops: the
    product's backward on bf16 operands."""
    h = _mm(layernorm(x, ln_w, ln_b), w_qkv, bf16_ops)
    return depthwise3x3(_wide(h), _wide(dwk)).to(x.dtype)


def block_tail_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, bf16_ops=False):
    """y = t + gate @ W_out, t = x + a @ W_proj, rounded to x's dtype after
    each product, each residual add, the LN and the gate; the stencil and
    the gate in at least fp32 (pallas_block.py:111-142); bf16_ops: the
    products' backward on bf16 operands."""
    t = (_wide(x) + _wide(_mm(a, w_proj, bf16_ops))).to(x.dtype)
    h = depthwise3x3(_wide(_mm(layernorm(t, ln_w, ln_b), w_in, bf16_ops)), _wide(dwk))
    return (_wide(t) + _wide(_mm(gated(h).to(x.dtype), w_out, bf16_ops))).to(x.dtype)


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


def _st(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """v with the value of v rounded to dtype and the gradient of v: a
    rounding point of the JAX forward that its backward kernel recomputes
    and differentiates as the identity. No rounding in v's own dtype."""
    return v + (v.to(dtype).to(v.dtype) - v).detach()


def _vjp_widened(fn, inputs, g):
    """Grads of fn(*inputs) for the cotangent g as the JAX backward kernels
    take them on bf16 (RCOT_BWD_BF16 unset): every input and g widened to
    at least fp32, fn (its rounding points _st) differentiated there, and
    each grad rounded once to its input's dtype (the kernels' bf16 outputs
    and the VJPs' .astype(w.dtype)); None stays None."""
    grads = _vjp_plain(fn, [None if t is None else _wide(t) for t in inputs], _wide(g))
    return tuple(None if d is None else d.to(t.dtype) for d, t in zip(grads, inputs))


def _block_tail_rounded(dtype, x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, bf16_ops=False):
    """The tail in fp32 as the JAX backward kernel recomputes and
    differentiates it (pallas_block.py:286-397): pre, t, u and h rounded to
    dtype; conv, the gate (dW_out takes it unrounded) and the rest fp32;
    bf16_ops: the products' backward on bf16 operands."""
    t = _st(x + _st(_prod(a, w_proj, bf16_ops), dtype), dtype)
    h = _st(_prod(_st(layernorm(t, ln_w, ln_b), dtype), w_in, bf16_ops), dtype)
    return t + _prod(gated(depthwise3x3(h, dwk)), w_out, bf16_ops)


def block_tail_bwd_bf16_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g, bf16_ops=False):
    """The bf16 tail backward as the JAX kernel computes it -> (dx, da,
    dw_proj, dln_w, dln_b, dw_in, ddw, dw_out), bf16 but dln_w, dln_b."""
    return _vjp_widened(functools.partial(_block_tail_rounded, x.dtype, bf16_ops=bf16_ops),
                        (x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out), g)


def _block_head_rounded(dtype, x, ln_w, ln_b, w_qkv, dwk, bf16_ops=False):
    """The head in fp32 as the JAX backward kernel recomputes and
    differentiates it (pallas_block.py:270-309): u and h rounded to dtype,
    the stencil fp32; bf16_ops: the product's backward on bf16 operands."""
    u = _st(layernorm(x, ln_w, ln_b), dtype)
    return depthwise3x3(_st(_prod(u, w_qkv, bf16_ops), dtype), dwk)


def block_head_bwd_bf16_plain(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops=False):
    """The bf16 head backward as the JAX kernel computes it -> (dx, dln_w,
    dln_b, dw_qkv, ddw), bf16 but dln_w, dln_b."""
    return _vjp_widened(functools.partial(_block_head_rounded, x.dtype, bf16_ops=bf16_ops),
                        (x, ln_w, ln_b, w_qkv, dwk), g)


def block_head_bwd_plain(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops=False):
    """-> (dx, dln_w, dln_b, dw_qkv, ddw); on bf16 block_head_bwd_bf16_plain;
    bf16_ops: the products on bf16 operands."""
    if x.dtype == torch.bfloat16:
        return block_head_bwd_bf16_plain(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops)
    return _vjp_plain(functools.partial(block_head_plain, bf16_ops=bf16_ops),
                      (x, ln_w, ln_b, w_qkv, dwk), g)


def block_tail_bwd_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g, bf16_ops=False):
    """-> (dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out); on bf16
    block_tail_bwd_bf16_plain; bf16_ops: the products on bf16 operands."""
    if x.dtype == torch.bfloat16:
        return block_tail_bwd_bf16_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g,
                                         bf16_ops)
    return _vjp_plain(functools.partial(block_tail_plain, bf16_ops=bf16_ops),
                      (x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out), g)


# ---------------------------------------------------------------- kernels

def block_head_fwd(x: torch.Tensor, ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
                   w_qkv: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) -> qkv (B,H,W,M); w_qkv (M,C), dwk (M,3,3), in x's
    dtype (fp32, or bf16 with fp32 ln_w, ln_b). On the card two calls on
    the same inputs give the same bits."""
    if not x.is_cuda:
        return block_head_plain(x, ln_w, ln_b, w_qkv, dwk)
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    n = b * h * w
    dev = x.device
    dt = build.kernel_dtype(x)
    bf16 = dt == torch.bfloat16
    for name, t, shape, want in (("x", x, (b, h, w, c), dt), ("ln_w", ln_w, (c,), None),
                                 ("ln_b", ln_b, (c,), None), ("w_qkv", w_qkv, (m, c), dt),
                                 ("dwk", dwk, (m, 3, 3), dt)):
        build.check_arg(name, t, shape, dev, want or torch.float32)
    _check_channels(c)
    if bf16:
        return _block_head_bf16(x, ln_w, ln_b, w_qkv, dwk)
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


def _block_head_bf16(x, ln_w, ln_b, w_qkv, dwk, launches: bool = False):
    """block_head_fwd on bf16 CUDA tensors (csrc/block_fwd_bf16.cu): ln_fwd
    into u, then one launch of the product-depthwise (csrc/pw_dw.cu, its
    plan pw_card_plan), which keeps h in the SM. With `launches`, or where
    C passes the product-depthwise's shared memory
    (kdw.pw_dw_max_channels), the bf16 product and the depthwise in
    launches of their own through h in device memory (the same bits)."""
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    n = b * h * w
    dev = x.device
    out = torch.empty(b, h, w, m, device=dev, dtype=torch.bfloat16)
    vec_c = kdw.bf16_vec(c, x.data_ptr(), w_qkv.data_ptr())
    pw = None if launches else pw_card_plan(b, h, w, c, m, dev.index, vec_c,
                                            _even_width(m, out.data_ptr()))
    sizes = fwd_workspace_numel(n, c, m, False, True)  # u, stats
    buf, ws = _workspaces(dev, sizes if pw else sizes + (_cdiv(n * m, 2),))  # and h
    vecs = _fwd_vecs_bf16(c, m, False, {"u": ws[0], "w_qkv": w_qkv.data_ptr(),
                                        "h": ws[2] if pw is None else 0,
                                        "out": out.data_ptr()})
    plan, n_sums = _fwd_card_plan(b, h, w, c, m, False, dev.index, *vecs, True)
    sums = torch.empty(n_sums, device=dev) if n_sums and pw is None else None
    with torch.cuda.device(dev):
        build.call("rcot_block_head_bf16", x.data_ptr(), ln_w.data_ptr(), build.ptr(ln_b),
                   w_qkv.data_ptr(), dwk.data_ptr(), out.data_ptr(), ws[0], ws[1],
                   ws[2] if pw is None else None, build.ptr(sums), plan, pw, b, h, w, c, m,
                   build.stream())
    build.LAUNCHES["block_head_bf16"] += 1
    return out


def _odd_width(m: int) -> ValueError:
    return ValueError(f"bf16 block kernels: the depthwise width {m} must be even "
                      "(its copies move two bf16 at least)")


def _even_width(m: int, out: int) -> int:
    """bf16 a store of a bf16 depthwise's output (B,H,W,M) at out; M must be
    even."""
    vec = kdw.bf16_vec(m, out)
    if vec < 2:
        raise _odd_width(m)
    return vec


@functools.lru_cache(maxsize=None)
def pw_card_plan(b, h, w, c, m, device_index, vec_c, vec_out):
    """-> the product-depthwise's plan on this card (kdw.pw_dw_plan, its
    product's K split that of the design it replaces: split_plan) as a
    ctypes array, or None where it does not fit (C past
    kdw.pw_dw_max_channels)."""
    n_sm = sm_count(device_index)
    plan = kdw.pw_dw_plan(b, h, w, c, m, n_sm, vec_c, vec_out,
                          split_plan(b * h * w, m, c, n_sm))
    return None if plan is None else (ctypes.c_int * kdw.PW_PLAN_INTS)(*plan)


def block_tail_fwd(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
                   ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
                   w_in: torch.Tensor, dwk: torch.Tensor,
                   w_out: torch.Tensor) -> torch.Tensor:
    """x, a (B,H,W,C) -> y (B,H,W,C); w_proj (C,C), w_in (2h,C),
    dwk (2h,3,3), w_out (C,h), in x's dtype (fp32, or bf16 with fp32 ln_w,
    ln_b). On the card two calls on the same inputs give the same bits."""
    if not x.is_cuda:
        return block_tail_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    n = b * h * w
    dev = x.device
    dt = build.kernel_dtype(x)
    bf16 = dt == torch.bfloat16
    for name, t, shape, want in (("x", x, (b, h, w, c), dt), ("a", a, (b, h, w, c), dt),
                                 ("w_proj", w_proj, (c, c), dt), ("ln_w", ln_w, (c,), None),
                                 ("ln_b", ln_b, (c,), None), ("w_in", w_in, (2 * hid, c), dt),
                                 ("dwk", dwk, (2 * hid, 3, 3), dt),
                                 ("w_out", w_out, (c, hid), dt)):
        build.check_arg(name, t, shape, dev, want or torch.float32)
    _check_channels(c)
    y = torch.empty_like(x)
    # t, stats, u, h, and conv (fp32) or the gate (bf16)
    buf, ws = _workspaces(dev, fwd_workspace_numel(n, c, 2 * hid, True, bf16))
    ptrs = {"a": a.data_ptr(), "u": ws[2], "w_proj": w_proj.data_ptr(),
            "w_in": w_in.data_ptr(), "h": ws[3], ("gate" if bf16 else "conv"): ws[4],
            "w_out": w_out.data_ptr()}
    plan, n_sums = _fwd_card_plan(b, h, w, c, 2 * hid, True, dev.index,
                                  *fwd_vecs(c, 2 * hid, True, ptrs, bf16), bf16)
    sums = torch.empty(n_sums, device=dev) if n_sums else None
    kernel = "block_tail_bf16" if bf16 else "block_tail"
    with torch.cuda.device(dev):
        build.call("rcot_" + kernel,
                   *(t.data_ptr() for t in (x, a, w_proj, ln_w)), build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_in, dwk, w_out, y)), *ws, build.ptr(sums),
                   plan, b, h, w, c, hid, build.stream())
    build.LAUNCHES[kernel] += 1
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
# In bf16 (csrc/block_fwd_bf16.cu) the copy widths count bf16 elements
# (kdw.bf16_vec), the tail's depthwise takes the gate itself (the gated
# depthwise, kdw.conv_gate_plan: no gate pass, no fp32 conv in device
# memory) into a workspace of its own in rows of gate_ld(h, bf16) = h
# rounded up to 8, and the workspaces hold bf16 but for stats (fp32).
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
    gate_pass: int                       # 1: the fp32 tail's gate as a pass of its own
    sums_numel: int                      # floats of the split partials' workspace

    def ints(self) -> Tuple[int, ...]:
        out = (self.ln_blocks, self.vec_c, self.vec_h, self.vec_g,
               *(k for split in self.splits for k in split), *self.dw_conv, self.gate_pass)
        assert len(out) == FWD_PLAN_INTS
        return out


def block_fwd_plan(b: int, h: int, w: int, c: int, width: int, tail: bool, n_sm: int,
                   vecs: Tuple[int, int, int], dw_conv: Tuple[int, int, int, int],
                   bf16: bool = False) -> FwdPlan:
    """The plan of a forward on (B,H,W,C) with depthwise width `width` (2h
    in the tail, 3C in the head) on a card of n_sm SMs; vecs the copy
    widths of the C class, the h class and the gate's rows, dw_conv row
    11's (vec, cv, tc, rows) on (B,H,W,width) (the bf16 tail's the gated
    depthwise's, kdw.conv_gate_plan); bf16 the bf16 kernels' (no gate
    pass)."""
    n = b * h * w
    # (n, k) of t, h and out (None: not run)
    prods = ((c, c), (width, c), (c, width // 2)) if tail else (None, (width, c), None)
    splits = tuple((1, 0) if nk is None else split_plan(n, *nk, n_sm) for nk in prods)
    numel = max([0] + [s * n * nk[0] for (s, _), nk in zip(splits, prods) if s > 1])
    return FwdPlan(ln_plan(n, n_sm)[0], *vecs, splits, dw_conv,
                   int(tail and not bf16 and c > GATE_FUSED_MAX_C), numel)


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


def gate_ld(hid: int, bf16: bool = False) -> int:
    """Elements between rows of a gate pass's gate: 16 bytes' worth, hid
    rounded up to 4 floats or 8 bf16."""
    unit = 8 if bf16 else 4
    return _cdiv(hid, unit) * unit


def fwd_workspace_numel(n: int, c: int, width: int, tail: bool,
                        bf16: bool = False) -> Tuple[int, ...]:
    """Floats of each workspace of a forward on n pixels, in the order the
    kernel takes them: the tail's t, stats, u, h, conv (h's buffer takes
    the gate of a gate pass, n rows of gate_ld(h)), the head's u, stats, h;
    in bf16 all but stats hold bf16, two to a float, in place of conv the
    tail has the gate (n rows of gate_ld(h, bf16)), which its gated
    depthwise writes: no fp32 conv; and the head has no h: its
    product-depthwise keeps h in the SM (the launches that C past its
    shared memory takes add n x width bf16 of h)."""
    if bf16:
        if tail:
            return (_cdiv(n * c, 2), 2 * n, _cdiv(n * c, 2), _cdiv(n * width, 2),
                    _cdiv(n * gate_ld(width // 2, True), 2))
        return _cdiv(n * c, 2), 2 * n
    if tail:
        return n * c, 2 * n, n * c, n * max(width, gate_ld(width // 2)), n * width
    return n * c, 2 * n, n * width


def fwd_vecs(c: int, width: int, tail: bool, ptrs: dict,
             bf16: bool = False) -> Tuple[int, int, int, int]:
    """-> copy widths of the C class, the h class, the gate's rows and the
    depthwise width of a forward whose operands start at ptrs (name ->
    address): the tail's a, u, w_proj, w_in, h, conv (bf16: gate), w_out,
    the head's u, w_qkv, h, out. The h class takes conv's two halves (at
    columns 0 and h of its rows) and W_out's rows, the gate's rows lie
    gate_ld(h) floats apart in h's buffer; the head has neither (1). In
    bf16 the widths count bf16 (the h class is W_out's rows alone), the
    gate's rows lie gate_ld(h, bf16) apart in the gate's workspace, the
    head's depthwise copies at least two, so its width must be even, and
    the tail's is the gated depthwise's (kdw.conv_gate_vec)."""
    if bf16:
        return _fwd_vecs_bf16(c, width, tail, ptrs)
    if tail:
        hid = width // 2
        return (kdw.dwconv_vec(c, *(ptrs[k] for k in ("a", "u", "w_proj", "w_in"))),
                kdw.dwconv_vec(hid, *(ptrs[k] for k in ("conv", "w_out"))),
                kdw.dwconv_vec(gate_ld(hid), ptrs["h"]),
                kdw.dwconv_vec(width, ptrs["h"], ptrs["conv"]))
    return (kdw.dwconv_vec(c, ptrs["u"], ptrs["w_qkv"]), 1, 1,
            kdw.dwconv_vec(width, ptrs["h"], ptrs["out"]))


def _fwd_vecs_bf16(c: int, width: int, tail: bool, ptrs: dict) -> Tuple[int, int, int, int]:
    if tail:
        hid = width // 2
        vecs = (kdw.bf16_vec(c, *(ptrs[k] for k in ("a", "u", "w_proj", "w_in"))),
                kdw.bf16_vec(hid, ptrs["w_out"]),
                kdw.bf16_vec(gate_ld(hid, True), ptrs["gate"]),
                kdw.conv_gate_vec(hid, ptrs["h"]))
    else:
        vecs = (kdw.bf16_vec(c, ptrs["u"], ptrs["w_qkv"]), 1, 1,
                kdw.bf16_vec(width, ptrs["h"], ptrs["out"]))
    if vecs[3] < 2:
        raise _odd_width(width)
    return vecs


@functools.lru_cache(maxsize=None)
def _fwd_card_plan(b, h, w, c, width, tail, device_index, vec_c, vec_h, vec_g, vec_m,
                   bf16=False):
    """-> (the forward plan's ints as a ctypes array, floats of sums) on this
    card; the bf16 tail's depthwise the gated one."""
    if bf16 and tail:
        dw_conv = kdw.conv_gate_plan(b, h, w, width // 2, sm_count(device_index))
    else:
        dw_conv = (vec_m, *kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False,
                                           "bf16" if bf16 else "f32"))
    plan = block_fwd_plan(b, h, w, c, width, tail, sm_count(device_index),
                          (vec_c, vec_h, vec_g), dw_conv, bf16)
    return (ctypes.c_int * FWD_PLAN_INTS)(*plan.ints()), plan.sums_numel


def block_head_bwd(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops=False):
    """Backward of block_head for the cotangent g (B,H,W,M) ->
    (dx, dln_w, dln_b, dw_qkv, ddw); dln_b is None when ln_b is. In x's
    dtype (fp32, or bf16 with fp32 ln_w, ln_b: dx and the weight grads
    bf16, dln_w and dln_b fp32); bf16_ops: its products on bf16 operands
    (module docstring). On the card every sum runs in a fixed order, so
    two calls on the same inputs give the same bits."""
    if not x.is_cuda:
        return block_head_bwd_plain(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops)
    if x.dtype == torch.bfloat16:
        return _block_head_bwd_bf16(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops)
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
                   b, h, w, c, m, int(bf16_ops), build.stream())
    build.LAUNCHES[build.counted("block_head_bwd", bf16_ops)] += 1
    return dx, dln_w, dln_b, dw_qkv, ddw


def block_tail_bwd(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g, bf16_ops=False):
    """Backward of block_tail for the cotangent g (B,H,W,C) ->
    (dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out); dln_b is None when
    ln_b is. In x's dtype (fp32, or bf16 with fp32 ln_w, ln_b: the weight
    grads bf16, dln_w and dln_b fp32); bf16_ops: its products on bf16
    operands (module docstring). On the card every sum runs in a fixed
    order, so two calls on the same inputs give the same bits."""
    if not x.is_cuda:
        return block_tail_bwd_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk,
                                    w_out, g, bf16_ops)
    if x.dtype == torch.bfloat16:
        return _block_tail_bwd_bf16(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g, bf16_ops)
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
                   *(t.data_ptr() for t in ws), plan, b, h, w, c, hid, int(bf16_ops),
                   build.stream())
    build.LAUNCHES[build.counted("block_tail_bwd", bf16_ops)] += 1
    return tuple(outs)


def bwd_bf16_workspace_numel(n: int, c: int, hid: int) -> Tuple[int, ...]:
    """Floats of each workspace of the bf16 tail backward on n pixels, in
    the order csrc/block_bwd_bf16.cu takes them (bf16 ones two to a float):
    the recompute's tb, ub, hb; stats, conv_dh, dconv, gate, du, dt. No
    fp32 copy of an operand: its products and stencils read the bf16
    tensors as they are."""
    m2 = 2 * hid
    return (_cdiv(n * c, 2), _cdiv(n * c, 2), _cdiv(n * m2, 2),
            2 * n, n * m2, n * m2, n * hid, n * c, n * c)


def _block_tail_bwd_bf16(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g, bf16_ops):
    """block_tail_bwd on bf16 CUDA tensors: csrc/block_bwd_bf16.cu."""
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    m2 = 2 * hid
    n = b * h * w
    dev = x.device
    bf = torch.bfloat16
    for name, t, shape, want in (("x", x, (b, h, w, c), bf), ("a", a, (b, h, w, c), bf),
                                 ("w_proj", w_proj, (c, c), bf), ("ln_w", ln_w, (c,), None),
                                 ("ln_b", ln_b, (c,), None), ("w_in", w_in, (m2, c), bf),
                                 ("dwk", dwk, (m2, 3, 3), bf), ("w_out", w_out, (c, hid), bf),
                                 ("g", g, (b, h, w, c), bf)):
        build.check_arg(name, t, shape, dev, want or torch.float32)
    _check_channels(c)
    outs = [torch.empty_like(t) for t in (x, a, w_proj, ln_w)]
    outs += [None if ln_b is None else torch.empty_like(ln_b)]
    outs += [torch.empty_like(t) for t in (w_in, dwk, w_out)]
    buf, ws = _workspaces(dev, bwd_bf16_workspace_numel(n, c, hid))
    ub, hb, conv_dh, dconv, gate, du, dt = ws[1], ws[2], *ws[4:]
    # the fp32 design's plan: its copy widths those of the fp32 operands
    vec_c = kdw.dwconv_vec(c, du, dt)
    vec_h = kdw.dwconv_vec(hid, gate)
    vec_m = kdw.dwconv_vec(m2, conv_dh, dconv)
    plan, n_sums = _card_plan(b, h, w, c, m2, True, dev.index, vec_c, vec_h, vec_m)
    c_wide = (a.data_ptr(), ub, w_proj.data_ptr(), w_in.data_ptr())
    plan16 = _gated_bwd_bf16_card_plan(b, h, w, c, m2, dev.index,
                                       *gated_bf16_vecs(c, hid, c_wide, g.data_ptr(),
                                                        w_out.data_ptr(), hb, conv_dh))
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_block_tail_bwd_bf16",
                   *(t.data_ptr() for t in (x, a, w_proj, ln_w)), build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_in, dwk, w_out, g)),
                   *(build.ptr(t) for t in outs), *ws, sums.data_ptr(), plan, plan16,
                   b, h, w, c, hid, int(bf16_ops), build.stream())
    build.LAUNCHES[build.counted("block_tail_bwd_bf16", bf16_ops)] += 1
    return tuple(outs)


def head_bwd_bf16_workspace_numel(n: int, c: int, m: int) -> Tuple[int, ...]:
    """Floats of each workspace of the bf16 head backward on n pixels, in
    the order csrc/block_bwd_bf16.cu takes them (bf16 ones two to a float):
    the recompute's ub, hb; stats, dh, du. No fp32 copy of an operand: its
    products and stencils read the bf16 tensors as they are."""
    return _cdiv(n * c, 2), _cdiv(n * m, 2), 2 * n, n * m, n * c


def _block_head_bwd_bf16(x, ln_w, ln_b, w_qkv, dwk, g, bf16_ops):
    """block_head_bwd on bf16 CUDA tensors: csrc/block_bwd_bf16.cu."""
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    n = b * h * w
    dev = x.device
    bf = torch.bfloat16
    for name, t, shape, want in (("x", x, (b, h, w, c), bf), ("ln_w", ln_w, (c,), None),
                                 ("ln_b", ln_b, (c,), None), ("w_qkv", w_qkv, (m, c), bf),
                                 ("dwk", dwk, (m, 3, 3), bf), ("g", g, (b, h, w, m), bf)):
        build.check_arg(name, t, shape, dev, want or torch.float32)
    _check_channels(c)
    dx, dln_w, dw_qkv, ddw = (torch.empty_like(t) for t in (x, ln_w, w_qkv, dwk))
    dln_b = None if ln_b is None else torch.empty_like(ln_b)
    buf, ws = _workspaces(dev, head_bwd_bf16_workspace_numel(n, c, m))
    ub, hb, _, dh, du = ws
    # the fp32 design's plan: its copy widths those of the fp32 operands
    vec_m32 = kdw.dwconv_vec(m, dh)
    plan, n_sums = _card_plan(b, h, w, c, m, False, dev.index, kdw.dwconv_vec(c, du), 1, vec_m32)
    plan16 = _qkv_bwd_bf16_card_plan(b, h, w, c, m, dev.index,
                                     kdw.bf16_vec(c, ub, w_qkv.data_ptr()),
                                     kdw.bf16_vec(m, hb, g.data_ptr()), vec_m32)
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_block_head_bwd_bf16",
                   *(t.data_ptr() for t in (x, ln_w)), build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_qkv, dwk, g, dx, dln_w)), build.ptr(dln_b),
                   dw_qkv.data_ptr(), ddw.data_ptr(), *ws, sums.data_ptr(), plan, plan16,
                   b, h, w, c, m, int(bf16_ops), build.stream())
    build.LAUNCHES[build.counted("block_head_bwd_bf16", bf16_ops)] += 1
    return dx, dln_w, dln_b, dw_qkv, ddw


def gated_bf16_vecs(c: int, hid: int, c_wide: Tuple[int, ...], g: int, w_out: int, h: int,
                    conv: int) -> Tuple[int, int, int, int]:
    """-> bf16 a copy of the bf16 operands of the bf16 tail's or GDFN's
    backward, gated_bwd_bf16_plan's first four ints, from their addresses:
    the C-wide operands of its products (the tail's a, u, W_proj and W_in,
    the GDFN's x and W_in), the cotangent g (C wide), W_out's rows (h wide:
    an odd h copies single bf16) and the recompute's depthwise forward of h
    into fp32 conv (its width 2h)."""
    return (kdw.bf16_vec(c, *c_wide), kdw.bf16_vec(c, g), kdw.bf16_vec(hid, w_out),
            kdw.bf16_vec(2 * hid, h, f32_ptrs=(conv,)))


# The second plans of the bf16 backward forms on bf16 tiles, beside the fp32
# design's (block_bwd_plan, ops/fused.py fused_bwd_plan): the gated ones
# (row 5's tail, row 9's GDFN) and those whose dconv is their cotangent
# (row 9's qkv, row 5's head).
GATED16_PLAN_INTS = 7
BWD16_PLAN_INTS = 9


def gated_bwd_bf16_plan(vec_c: int, vec_g: int, vec_h: int,
                        dw: Tuple[int, int, int, int]) -> Tuple[int, ...]:
    """The bf16 tail's and the bf16 GDFN backward's second plan,
    GATED16_PLAN_INTS ints: bf16 a copy of the C-wide operands, of g and of
    W_out's rows, then the (vec, cv, tc, rows) of the depthwise forward of
    the bf16 h into fp32 conv. Their rotated depthwise and dtaps read the
    fp32 dconv, so they take the fp32 plan's tiles as they are."""
    out = (vec_c, vec_g, vec_h, *dw)
    assert len(out) == GATED16_PLAN_INTS
    return out


@functools.lru_cache(maxsize=None)
def _gated_bwd_bf16_card_plan(b, h, w, c, width, device_index, vec_c, vec_g, vec_h, vec_m):
    """-> gated_bwd_bf16_plan's ints as a ctypes array on this card, the
    depthwise forward at vec_m bf16 a copy."""
    if vec_m < 2:
        raise ValueError(f"bf16 block kernels: the depthwise width {width} must be even "
                         "(its copies move two bf16 at least)")
    dw = kdw.dwconv_plan(b, h, w, width, device_index, vec_m, False, "bf16_f32")
    return (ctypes.c_int * GATED16_PLAN_INTS)(*gated_bwd_bf16_plan(vec_c, vec_g, vec_h,
                                                                   (vec_m, *dw)))


def qkv_bwd_bf16_plan(m: int, vec_c: int, vec_m: int, rot: Tuple[int, int, int],
                      taps: Tuple[int, int, int]) -> Tuple[int, ...]:
    """The bf16 qkv's and the bf16 head backward's second plan,
    BWD16_PLAN_INTS ints: vec_c bf16 a copy of the C-wide operands of their
    1x1 backward (x or u, and W_in or W_qkv); the rotated depthwise of g
    (bf16 into fp32 dh) at vec_m bf16 a copy, on rot = (cv, tc, rows), its
    own plan at that width or the fp32 design's; dtaps of the bf16 h and g
    at vec_m on the columns and band of the fp32 design's taps = (cv, tc,
    rows), so that its sums keep their order (ops/dwconv.py retile)."""
    out = (vec_c, *kdw.retile(rot, m, vec_m), *kdw.retile(taps, m, vec_m))
    assert len(out) == BWD16_PLAN_INTS
    return out


@functools.lru_cache(maxsize=None)
def _qkv_bwd_bf16_card_plan(b, h, w, c, m, device_index, vec_c, vec_m, vec_m32):
    """-> qkv_bwd_bf16_plan's ints as a ctypes array on this card: the
    rotated depthwise on the bf16 kernel's own plan (on the fp32 design's
    where g takes single bf16 copies, a width the bf16 plan has no kernel
    for), dtaps on the fp32 design's (vec_m32 floats a copy)."""
    taps = kdw.dwconv_plan(b, h, w, m, device_index, vec_m32, True)
    rot = (kdw.dwconv_plan(b, h, w, m, device_index, vec_m, False, "bf16_f32") if vec_m > 1
           else kdw.dwconv_plan(b, h, w, m, device_index, vec_m32, False))
    ints = qkv_bwd_bf16_plan(m, vec_c, vec_m, rot, taps)
    return (ctypes.c_int * BWD16_PLAN_INTS)(*ints)


# --------------------------------------------------------------- autograd

class BlockHead(torch.autograd.Function):
    """block_head with its backward kernel; saves only inputs and weights;
    bf16_ops (not a tensor) picks the backward's operand form."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, dwk, bf16_ops):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, dwk)
        ctx.bf16_ops = bf16_ops
        return block_head_fwd(x, ln_w, ln_b, w_qkv, dwk)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.cat's backward arrives here
        return (*block_head_bwd(*ctx.saved_tensors, g.contiguous(), ctx.bf16_ops), None)


class BlockTail(torch.autograd.Function):
    """block_tail with its backward kernel; saves only inputs and weights;
    bf16_ops (not a tensor) picks the backward's operand form."""

    @staticmethod
    def forward(ctx, x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, bf16_ops):
        ctx.save_for_backward(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
        ctx.bf16_ops = bf16_ops
        return block_tail_fwd(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (*block_tail_bwd(*ctx.saved_tensors, g.contiguous(), ctx.bf16_ops), None)


def block_head(x: torch.Tensor, ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
               w_qkv: torch.Tensor, dwk: torch.Tensor, bf16_ops: bool = False) -> torch.Tensor:
    """Differentiable block head: x (B,H,W,C) -> qkv (B,H,W,M); bf16_ops:
    its backward's products on bf16 operands (RCOT_BWD_BF16's "block")."""
    return BlockHead.apply(x, ln_w, ln_b, w_qkv, dwk, bf16_ops)


def block_tail(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
               ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
               w_in: torch.Tensor, dwk: torch.Tensor,
               w_out: torch.Tensor, bf16_ops: bool = False) -> torch.Tensor:
    """Differentiable block tail: x, a (B,H,W,C) -> y (B,H,W,C); bf16_ops
    as block_head's."""
    return BlockTail.apply(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, bf16_ops)
