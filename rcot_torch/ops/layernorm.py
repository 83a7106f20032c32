"""Channel-last LayerNorm (BiasFree / WithBias) on (..., C) tensors.

Semantics of the reference (Net_Restormer.py:158-200): fp32 statistics
(float64 for a float64 input, as the float64 twins of the kernel checks
take), biased variance, eps 1e-5 inside the rsqrt. WithBias is
(x - mean) * inv * w + b; BiasFree is x * inv * w, with the variance taken
about the mean but x left uncentred.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-5


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + EPS)
    if bias is not None:
        y = (xf - mean) * inv * weight.to(xf.dtype) + bias.to(xf.dtype)
    else:
        y = xf * inv * weight.to(xf.dtype)
    return y.to(x.dtype)
