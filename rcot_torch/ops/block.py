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
autograd, so they share none of the kernels' formulas.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from .conv import conv1x1, depthwise3x3
from .gdfn import gated
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
    """x (B,H,W,C) -> qkv (B,H,W,M); w_qkv (M,C), dwk (M,3,3)."""
    if not x.is_cuda:
        return block_head_plain(x, ln_w, ln_b, w_qkv, dwk)
    b, h, w, c = x.shape
    m = w_qkv.shape[0]
    dev = x.device
    build.check_arg("x", x, (b, h, w, c), dev)
    build.check_arg("ln_w", ln_w, (c,), dev)
    build.check_arg("ln_b", ln_b, (c,), dev)
    build.check_arg("w_qkv", w_qkv, (m, c), dev)
    build.check_arg("dwk", dwk, (m, 3, 3), dev)
    out = torch.empty(b, h, w, m, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_block_head", x.data_ptr(), ln_w.data_ptr(),
                   build.ptr(ln_b), w_qkv.data_ptr(), dwk.data_ptr(),
                   out.data_ptr(), b, h, w, c, m, build.stream())
    build.LAUNCHES["block_head"] += 1
    return out


def block_tail_fwd(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
                   ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
                   w_in: torch.Tensor, dwk: torch.Tensor,
                   w_out: torch.Tensor) -> torch.Tensor:
    """x, a (B,H,W,C) -> y (B,H,W,C); w_proj (C,C), w_in (2h,C),
    dwk (2h,3,3), w_out (C,h). One launch is the two CUDA kernels of the
    tail (projection, then GDFN; csrc/block_fwd.cu says why)."""
    if not x.is_cuda:
        return block_tail_plain(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out)
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    dev = x.device
    build.check_arg("x", x, (b, h, w, c), dev)
    build.check_arg("a", a, (b, h, w, c), dev)
    build.check_arg("w_proj", w_proj, (c, c), dev)
    build.check_arg("ln_w", ln_w, (c,), dev)
    build.check_arg("ln_b", ln_b, (c,), dev)
    build.check_arg("w_in", w_in, (2 * hid, c), dev)
    build.check_arg("dwk", dwk, (2 * hid, 3, 3), dev)
    build.check_arg("w_out", w_out, (c, hid), dev)
    t_scratch = torch.empty_like(x)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        build.call("rcot_block_tail", x.data_ptr(), a.data_ptr(),
                   w_proj.data_ptr(), ln_w.data_ptr(), build.ptr(ln_b),
                   w_in.data_ptr(), dwk.data_ptr(), w_out.data_ptr(),
                   t_scratch.data_ptr(), y.data_ptr(), b, h, w, c, hid,
                   build.stream())
    build.LAUNCHES["block_tail"] += 1
    return y


def block_head_bwd(x, ln_w, ln_b, w_qkv, dwk, g):
    """Backward of block_head for the cotangent g (B,H,W,M) ->
    (dx, dln_w, dln_b, dw_qkv, ddw); dln_b is None when ln_b is."""
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
    dx = torch.empty_like(x)
    dln_w = torch.empty_like(ln_w)
    dln_b = None if ln_b is None else torch.empty_like(ln_b)
    dw_qkv = torch.empty_like(w_qkv)
    ddw = torch.empty_like(dwk)
    ws = [torch.empty(k, device=dev) for k in (n * c, 2 * n, n * m, n * m, n * c)]
    with torch.cuda.device(dev):
        build.call("rcot_block_head_bwd", x.data_ptr(), ln_w.data_ptr(),
                   build.ptr(ln_b), w_qkv.data_ptr(), dwk.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), dln_w.data_ptr(),
                   build.ptr(dln_b), dw_qkv.data_ptr(), ddw.data_ptr(),
                   *(t.data_ptr() for t in ws), b, h, w, c, m, build.stream())
    build.LAUNCHES["block_head_bwd"] += 1
    return dx, dln_w, dln_b, dw_qkv, ddw


def block_tail_bwd(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g):
    """Backward of block_tail for the cotangent g (B,H,W,C) ->
    (dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out); dln_b is None when
    ln_b is."""
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
    outs = [torch.empty_like(t) for t in (x, a, w_proj, ln_w)]
    dln_b = None if ln_b is None else torch.empty_like(ln_b)
    outs += [dln_b] + [torch.empty_like(t) for t in (w_in, dwk, w_out)]
    # t, stats, u, h, conv/dh, dconv, dgate, gate, du
    sizes = (n * c, 2 * n, n * c, 2 * n * hid, 2 * n * hid, 2 * n * hid,
             n * hid, n * hid, n * c)
    ws = [torch.empty(k, device=dev) for k in sizes]
    with torch.cuda.device(dev):
        build.call("rcot_block_tail_bwd",
                   *(t.data_ptr() for t in (x, a, w_proj, ln_w)),
                   build.ptr(ln_b),
                   *(t.data_ptr() for t in (w_in, dwk, w_out, g)),
                   *(build.ptr(t) for t in outs),
                   *(t.data_ptr() for t in ws), b, h, w, c, hid, build.stream())
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
