"""NHWC convolutions with PyTorch-layout (OIHW) weights.

Activations stay (B, H, W, C). A convolution views them as NCHW tensors in
the channels_last memory format, so cuDNN and the CPU backend read them in
place, and the result comes back as a contiguous NHWC tensor. Padding is
symmetric, k // 2 unless given (SAME at stride 1, as T_net uses it; the
critic's stride-2 4x4 convs pad 1). Weights and biases are cast to the
activation's dtype where they are used, as rcot_tpu/ops/conv.py:45,52,92-94
casts them (a bf16 activation with an fp32 parameter would otherwise run,
or promote, in fp32); an fp32 parameter of an fp32 activation is used as it
is, no copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _as(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """t (a weight or bias, or None) in x's dtype."""
    return None if t is None else t.to(x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: Optional[int] = None, groups: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin), weight (Cout, Cin/groups, k, k) -> (B,H',W',Cout)."""
    pad = weight.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), _as(weight, x), _as(bias, x), stride=stride,
                 padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in), weight (out, in) as nn.Linear holds it -> (..., out)."""
    return F.linear(x, _as(weight, x), _as(bias, x))


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv as a product over channels; weight (Cout, Cin[, 1, 1])."""
    y = x @ _as(weight, x).reshape(weight.shape[0], -1).t()
    return y + _as(bias, x) if bias is not None else y


def depthwise3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME depthwise conv; weight (C, 1, 3, 3) or (C, 3, 3)."""
    c = x.shape[-1]
    return conv2d(x, weight.reshape(c, 1, 3, 3), bias, groups=c)
