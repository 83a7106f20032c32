"""GDFN: gated-DConv feed-forward network, plain PyTorch.

Reference Net_Restormer.py:67-85: 1x1 conv to 2*hidden with
hidden = int(dim * ffn_expansion_factor) (127/255/510/1021 at dim 48),
3x3 depthwise conv, split, gelu(x1) * x2 with the exact-erf gelu, 1x1 conv
back to dim.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .conv import conv1x1, depthwise3x3


def hidden_features(dim: int, ffn_expansion_factor: float,
                    multiple: int = 1) -> int:
    hid = int(dim * ffn_expansion_factor)
    return -(-hid // multiple) * multiple


def gated(h: torch.Tensor) -> torch.Tensor:
    x1, x2 = h.chunk(2, dim=-1)
    return F.gelu(x1, approximate="none") * x2


def gdfn(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
         w_out: torch.Tensor, b_in: Optional[torch.Tensor] = None,
         b_dw: Optional[torch.Tensor] = None,
         b_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C). Bias-free, the whole GDFN is one fused
    kernel (gdfn_fused, as rcot_tpu/ops/gdfn.py:44-58 routes); with biases,
    plain ops."""
    if b_in is None and b_dw is None and b_out is None:
        # imported here: ops/fused.py takes `gated` from this module
        from .fused import gdfn_fused
        m = w_in.shape[0]
        return gdfn_fused(x, w_in.reshape(m, -1), w_dw.reshape(m, 3, 3),
                          w_out.reshape(w_out.shape[0], -1))
    h = depthwise3x3(conv1x1(x, w_in, b_in), w_dw, b_dw)
    return conv1x1(gated(h), w_out, b_out)
