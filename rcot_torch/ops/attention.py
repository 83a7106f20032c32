"""MDTA: multi-DConv-head transposed (channel) attention, plain PyTorch.

Reference Net_Restormer.py:19-50. q, k and v come from a 1x1 conv and a
3x3 depthwise conv; per head, q and k are L2-normalised along the spatial
axis (eps 1e-12, as F.normalize) and attention is the (c, c) matrix
softmax(q k^T * temperature). `mdta` is the composition the bias=True model
takes; the bias-free model runs the Gram kernels of ops/gram.py instead,
and its qkv half through `mdta_qkv`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv import conv1x1, depthwise3x3
from .fused import conv1x1_dw_fused

L2_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = x.square().sum(dim=-1, keepdim=True).sqrt()
    return x / norm.clamp_min(L2_EPS)


def mdta_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                temperature: torch.Tensor) -> torch.Tensor:
    """Transposed attention on (B, heads, c, HW) tensors -> same shape."""
    q = _l2_normalize(q)
    k = _l2_normalize(k)
    attn = torch.einsum("bhcn,bhdn->bhcd", q, k) * temperature
    attn = attn.softmax(dim=-1)
    return torch.einsum("bhcd,bhdn->bhcn", attn, v)


def mdta_core(temperature: torch.Tensor, qkv: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """Head split, attend and merge on the post-dwconv qkv (B,H,W,3C)."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    parts = qkv.reshape(b, h * w, 3, num_heads, c // num_heads)
    parts = parts.permute(2, 0, 3, 4, 1)  # (3, B, heads, ch, HW)
    out = mdta_attend(parts[0], parts[1], parts[2], temperature)
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c)


def mdta_qkv(x: torch.Tensor, w_qkv: torch.Tensor, w_dw: torch.Tensor,
             b_qkv: Optional[torch.Tensor] = None,
             b_dw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 qkv projection then its 3x3 depthwise conv: (B,H,W,C) -> 3C.
    Bias-free, the two run as one fused kernel (conv1x1_dw_fused, as
    rcot_tpu/ops/attention.py:89-117 routes); with biases, as plain convs."""
    if b_qkv is None and b_dw is None:
        m = w_qkv.shape[0]
        return conv1x1_dw_fused(x, w_qkv.reshape(m, -1), w_dw.reshape(m, 3, 3))
    return depthwise3x3(conv1x1(x, w_qkv, b_qkv), w_dw, b_dw)


def mdta(x: torch.Tensor, temperature: torch.Tensor, w_qkv: torch.Tensor,
         w_dw: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
         b_qkv: Optional[torch.Tensor] = None, b_dw: Optional[torch.Tensor] = None,
         b_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole MDTA: (B, H, W, C) -> (B, H, W, C)."""
    qkv = mdta_qkv(x, w_qkv, w_dw, b_qkv, b_dw)
    return conv1x1(mdta_core(temperature, qkv, num_heads), w_proj, b_proj)
