"""NHWC convolutions with PyTorch-layout (OIHW) weights.

Activations stay (B, H, W, C). A convolution views them as NCHW tensors in
the channels_last memory format, so cuDNN and the CPU backend read them in
place, and the result comes back as a contiguous NHWC tensor. Padding is
SAME (k // 2) at stride 1, the only form the model uses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin), weight (Cout, Cin/groups, k, k) -> (B,H,W,Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                 padding=weight.shape[-1] // 2, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv as a product over channels; weight (Cout, Cin[, 1, 1])."""
    y = x @ weight.reshape(weight.shape[0], -1).t()
    return y + bias if bias is not None else y


def depthwise3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME depthwise conv; weight (C, 1, 3, 3) or (C, 3, 3)."""
    c = x.shape[-1]
    return conv2d(x, weight.reshape(c, 1, 3, 3), bias, groups=c)
