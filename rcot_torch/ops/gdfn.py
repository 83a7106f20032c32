"""GDFN: gated-DConv feed-forward network, plain PyTorch.

Reference Net_Restormer.py:67-85: 1x1 conv to 2*hidden with
hidden = int(dim * ffn_expansion_factor) (127/255/510/1021 at dim 48),
3x3 depthwise conv, split, gelu(x1) * x2 with the exact-erf gelu, 1x1 conv
back to dim.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .conv import conv1x1, depthwise3x3
from .dwconv import dwconv3x3


def hidden_features(dim: int, ffn_expansion_factor: float,
                    multiple: int = 1) -> int:
    hid = int(dim * ffn_expansion_factor)
    return -(-hid // multiple) * multiple


def gated(h: torch.Tensor) -> torch.Tensor:
    """gelu(x1) * x2 of the halves of h. On a bf16 h, as jax.nn.gelu
    (approximate=False) and the product run on bf16 in XLA ops, each
    rounding to bf16: 0.5 x (erfc(-x sqrt(0.5))) with sqrt(0.5) in bf16,
    rounded after the scale, the erfc, the gelu's product and the gate's
    (rcot_tpu/ops/gdfn.py:75; jax/_src/nn/functions.py gelu). The kernel
    twins widen h first and take the gate in fp32."""
    x1, x2 = h.chunk(2, dim=-1)
    if h.dtype != torch.bfloat16:
        return F.gelu(x1, approximate="none") * x2
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=h.dtype)
    return 0.5 * x1 * torch.special.erfc(-x1 * sqrt_half) * x2


def gdfn(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
         w_out: torch.Tensor, b_in: Optional[torch.Tensor] = None,
         b_dw: Optional[torch.Tensor] = None,
         b_out: Optional[torch.Tensor] = None,
         depthwise: str = "fused", bf16_ops: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C), routed as rcot_tpu/ops/gdfn.py:44-75.
    Bias-free, in the depthwise tier named: "fused", the whole GDFN in one
    kernel (gdfn_fused; bf16_ops: its backward's products on bf16
    operands); "dwconv", the 1x1 as a product, the depthwise kernel
    (dwconv3x3), the gate and the 1x1 out. With biases, plain ops."""
    if b_in is None and b_dw is None and b_out is None:
        m = w_in.shape[0]
        if depthwise == "fused":
            # imported here: ops/fused.py takes `gated` from this module
            from .fused import gdfn_fused
            return gdfn_fused(x, w_in.reshape(m, -1), w_dw.reshape(m, 3, 3),
                              w_out.reshape(w_out.shape[0], -1), bf16_ops)
        if depthwise != "dwconv":
            raise ValueError(f"unknown depthwise tier {depthwise!r}")
        h = dwconv3x3(conv1x1(x, w_in), w_dw.reshape(m, 3, 3))
        return conv1x1(gated(h), w_out)
    h = depthwise3x3(conv1x1(x, w_in, b_in), w_dw, b_dw)
    return conv1x1(gated(h), w_out, b_out)
