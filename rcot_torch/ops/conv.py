"""NHWC convolutions with PyTorch-layout (OIHW) weights.

Activations stay (B, H, W, C). A convolution views them as NCHW tensors in
the channels_last memory format, so cuDNN and the CPU backend read them in
place, and the result comes back as a contiguous NHWC tensor. Padding is
symmetric, k // 2 unless given (SAME at stride 1, as T_net uses it; the
critic's stride-2 4x4 convs pad 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: Optional[int] = None, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin), weight (Cout, Cin/groups, k, k) -> (B,H',W',Cout)."""
    pad = weight.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in), weight (out, in) as nn.Linear holds it -> (..., out)."""
    return F.linear(x, weight, bias)


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
