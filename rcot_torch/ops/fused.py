"""Fused [1x1 ->] depthwise 3x3 [-> gelu gate -> 1x1], forward and backward.

Counterpart of rcot_tpu/ops/pallas_fused.py, in the two configurations the
model calls:

  conv1x1_dw_fused(x, w_in, dwk):        qkv = dw3x3( x @ W_in^T )
  gdfn_fused(x, w_in, dwk, w_out):       y = ( gelu(c1) * c2 ) @ W_out^T,
                                         [c1 | c2] = dw3x3( x @ W_in^T )

Weights are in the port's layouts, as ops/block.py takes them: w_in (M, C),
dwk (M, 3, 3), w_out (C, h) with M = 2h in the GDFN. The odd gate widths
of the reference model (h = 127, 255, ...) are masked inside the kernel;
nothing is padded.

`FusedDwconv` is the autograd Function. As the JAX custom VJP does, its
forward saves only x and the weights, and the backward recomputes the
rest. A CUDA tensor goes to the kernels of csrc/fused_dwconv.cu, a CPU
tensor to the plain twins below (composed from the port's ops, the backward
by autograd on them). Launches are counted under conv1x1_dw, gdfn_fused and
their *_bwd names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from .block import _vjp_plain
from .conv import conv1x1, depthwise3x3
from .gdfn import gated


# ------------------------------------------------------------------ plain

def fused_dwconv_plain(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                       w_out: Optional[torch.Tensor]) -> torch.Tensor:
    """w_out None: the qkv configuration; else the GDFN (gate, then W_out)."""
    h = depthwise3x3(conv1x1(x, w_in), dwk)
    return h if w_out is None else conv1x1(gated(h), w_out)


def fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g):
    """-> (dx, dw_in, ddw, dw_out); dw_out is None when w_out is."""
    return _vjp_plain(fused_dwconv_plain, (x, w_in, dwk, w_out), g)


# ---------------------------------------------------------------- kernels

def _check(x, w_in, dwk, w_out, g=None):
    b, h, w, c = x.shape
    m = w_in.shape[0]
    dev = x.device
    build.check_arg("x", x, (b, h, w, c), dev)
    build.check_arg("w_in", w_in, (m, c), dev)
    build.check_arg("dwk", dwk, (m, 3, 3), dev)
    if w_out is not None:
        if m % 2:
            raise ValueError(f"the gate needs an even width, got {m}")
        build.check_arg("w_out", w_out, (c, m // 2), dev)
    build.check_arg("g", g, (b, h, w, m if w_out is None else c), dev)
    return b, h, w, c, m


def fused_dwconv_fwd(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                     w_out: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,H,W,C) -> (B,H,W,M) without w_out, (B,H,W,C) with it."""
    if not x.is_cuda:
        return fused_dwconv_plain(x, w_in, dwk, w_out)
    b, h, w, c, m = _check(x, w_in, dwk, w_out)
    with torch.cuda.device(x.device):
        if w_out is None:
            out = torch.empty(b, h, w, m, device=x.device)
            build.call("rcot_conv1x1_dw", x.data_ptr(), w_in.data_ptr(),
                       dwk.data_ptr(), out.data_ptr(), b, h, w, c, m,
                       build.stream())
            build.LAUNCHES["conv1x1_dw"] += 1
        else:
            out = torch.empty_like(x)
            build.call("rcot_gdfn_fused", x.data_ptr(), w_in.data_ptr(),
                       dwk.data_ptr(), w_out.data_ptr(), out.data_ptr(), b, h,
                       w, c, m // 2, build.stream())
            build.LAUNCHES["gdfn_fused"] += 1
    return out


def fused_dwconv_bwd(x: torch.Tensor, w_in: torch.Tensor, dwk: torch.Tensor,
                     w_out: Optional[torch.Tensor], g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Backward of fused_dwconv_fwd for the cotangent g ->
    (dx, dw_in, ddw, dw_out); dw_out is None when w_out is."""
    if not x.is_cuda:
        return fused_dwconv_bwd_plain(x, w_in, dwk, w_out, g)
    b, h, w, c, m = _check(x, w_in, dwk, w_out, g)
    n = b * h * w
    dev = x.device
    dx, dw_in, ddw = (torch.empty_like(t) for t in (x, w_in, dwk))
    with torch.cuda.device(dev):
        if w_out is None:
            ws = [torch.empty(n * m, device=dev) for _ in range(2)]  # h, dh
            build.call("rcot_conv1x1_dw_bwd", x.data_ptr(), w_in.data_ptr(),
                       dwk.data_ptr(), g.data_ptr(), dx.data_ptr(),
                       dw_in.data_ptr(), ddw.data_ptr(),
                       *(t.data_ptr() for t in ws), b, h, w, c, m,
                       build.stream())
            build.LAUNCHES["conv1x1_dw_bwd"] += 1
            return dx, dw_in, ddw, None
        hid = m // 2
        dw_out = torch.empty_like(w_out)
        # h, conv/dh, dconv, dgate, gate
        ws = [torch.empty(k, device=dev) for k in (n * m, n * m, n * m, n * hid, n * hid)]
        build.call("rcot_gdfn_fused_bwd", x.data_ptr(), w_in.data_ptr(),
                   dwk.data_ptr(), w_out.data_ptr(), g.data_ptr(), dx.data_ptr(),
                   dw_in.data_ptr(), ddw.data_ptr(), dw_out.data_ptr(),
                   *(t.data_ptr() for t in ws), b, h, w, c, hid, build.stream())
        build.LAUNCHES["gdfn_fused_bwd"] += 1
    return dx, dw_in, ddw, dw_out


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
