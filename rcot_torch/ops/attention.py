"""MDTA: multi-DConv-head transposed (channel) attention.

Reference Net_Restormer.py:19-50. q, k and v come from a 1x1 conv and a
3x3 depthwise conv; per head, q and k are L2-normalised along the spatial
axis (eps 1e-12, as F.normalize) and attention is the (c, c) matrix
softmax(q k^T * temperature). `mdta` is the composition the bias=True model
takes, in plain ops; the bias-free model runs its qkv half through
`mdta_qkv` and its core through `mdta_core`, each in the tier the model
names (ops/dispatch.py), as rcot_tpu/ops/attention.py:56-117 routes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .conv import conv1x1, depthwise3x3
from .dwconv import dwconv3x3
from .fused import conv1x1_dw_fused
from .gram import mdta_core_gram
from .mdta import mdta_attend_plain as mdta_attend
from .mdta import mdta_attend as mdta_attend_kernel


def _attend_heads(attend: Callable, temperature: torch.Tensor, qkv: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """Head split (transpose to (3, B, heads, ch, HW)), attend and merge
    back to NHWC, on the post-dwconv qkv (B,H,W,3C)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    parts = qkv.reshape(b, h * w, 3, num_heads, c // num_heads)
    parts = parts.permute(2, 0, 3, 4, 1).contiguous()
    out = attend(parts[0], parts[1], parts[2], temperature)
    # with one head the merge is a strided view; the tail kernel reads NHWC
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c).contiguous()


def mdta_core(temperature: torch.Tensor, qkv: torch.Tensor, num_heads: int,
              core: str = "mdta", bf16_ops: bool = False) -> torch.Tensor:
    """The attention core of the bias-free model, (B,H,W,3C) -> (B,H,W,C).
    "gram": the transpose-free Gram and apply kernels (ops/gram.py), their
    backward's products on bf16 operands with bf16_ops; "mdta" (the
    default, the transposed formulation): the transposes and the fused
    attend kernel (ops/mdta.py), whose backward has no such form."""
    if core == "gram":
        return mdta_core_gram(temperature, qkv, num_heads, bf16_ops)
    if core != "mdta":
        raise ValueError(f"unknown attention core {core!r}")
    return _attend_heads(mdta_attend_kernel, temperature, qkv, num_heads)


def mdta_qkv(x: torch.Tensor, w_qkv: torch.Tensor, w_dw: torch.Tensor,
             b_qkv: Optional[torch.Tensor] = None,
             b_dw: Optional[torch.Tensor] = None,
             depthwise: str = "fused", bf16_ops: bool = False) -> torch.Tensor:
    """1x1 qkv projection then its 3x3 depthwise conv: (B,H,W,C) -> 3C.
    Bias-free, in the depthwise tier named: "fused", one kernel
    (conv1x1_dw_fused; bf16_ops: its backward's products on bf16
    operands); "dwconv", the 1x1 as a product, then the depthwise kernel
    (dwconv3x3). With biases, plain convs."""
    if b_qkv is None and b_dw is None:
        m = w_qkv.shape[0]
        if depthwise == "fused":
            return conv1x1_dw_fused(x, w_qkv.reshape(m, -1), w_dw.reshape(m, 3, 3), bf16_ops)
        if depthwise != "dwconv":
            raise ValueError(f"unknown depthwise tier {depthwise!r}")
        return dwconv3x3(conv1x1(x, w_qkv), w_dw.reshape(m, 3, 3))
    return depthwise3x3(conv1x1(x, w_qkv, b_qkv), w_dw, b_dw)


def mdta(x: torch.Tensor, temperature: torch.Tensor, w_qkv: torch.Tensor,
         w_dw: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
         b_qkv: Optional[torch.Tensor] = None, b_dw: Optional[torch.Tensor] = None,
         b_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole MDTA, the attend in plain ops: (B, H, W, C) -> (B, H, W, C)."""
    qkv = mdta_qkv(x, w_qkv, w_dw, b_qkv, b_dw)
    a = _attend_heads(mdta_attend, temperature, qkv, num_heads)
    return conv1x1(a, w_proj, b_proj)
