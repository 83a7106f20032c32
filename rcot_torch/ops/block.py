"""Fused transformer-block head and tail.

Counterpart of rcot_tpu/ops/pallas_block.py (forward only):

  block_head: qkv = dw3x3( LN1(x) @ W_qkv )
  block_tail: t = x + a @ W_proj
              y = t + ( gelu(c1) * c2 ) @ W_out,  [c1 | c2] = dw3x3( LN2(t) @ W_in )

Weights are taken in PyTorch's conv layouts, as the modules hold them:
w_qkv (3C, C), w_proj (C, C), w_in (2h, C), w_out (C, h) and depthwise
kernels (M, 3, 3). A CUDA tensor goes to the kernels of csrc/block_fwd.cu;
a CPU tensor to the plain twins below, composed from the port's ops.
"""

from __future__ import annotations

from typing import Optional

import torch

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


# ---------------------------------------------------------------- kernels

def block_head(x: torch.Tensor, ln_w: torch.Tensor, ln_b: Optional[torch.Tensor],
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
                   out.data_ptr(), b, h, w, c, m,
                   torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES["block_head"] += 1
    return out


def block_tail(x: torch.Tensor, a: torch.Tensor, w_proj: torch.Tensor,
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
                   torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES["block_tail"] += 1
    return y
