"""Fourier residual transport cost.

Counterpart of rcot_tpu/ops/fourier.py; reference trainer.py:320-335.
res = degraded - T(degraded); per sample, on fft2(res) over H and W:

- de_id < 3 (noise): torch.mean(abs(F)**2)**1/2, which by operator
  precedence is HALF THE MEAN POWER, not an RMS ("reference"); "clean"
  takes the intended RMS sqrt(mean |F|^2);
- de_id >= 3: mean(|F|);

summed over the batch. The companion term is sqrt(mean(res^2)) over the
whole batch (an RMSE).
"""

from __future__ import annotations

import torch


def fourier_residual_penalty(res: torch.Tensor, de_id: torch.Tensor,
                             loss_math: str = "reference") -> torch.Tensor:
    """res (B, H, W, C), de_id (B,) int -> scalar (batch sum)."""
    mag = torch.fft.fft2(res.float(), dim=(1, 2)).abs()
    mean_pow = mag.square().mean(dim=(1, 2, 3))
    mean_mag = mag.mean(dim=(1, 2, 3))
    if loss_math == "reference":
        noise_term = mean_pow / 2.0
    elif loss_math == "clean":
        noise_term = mean_pow.sqrt()
    else:
        raise ValueError(f"unknown loss_math {loss_math!r}")
    return torch.where(de_id < 3, noise_term, mean_mag).sum()


def residual_rmse(res: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(res^2)) over the whole batch."""
    return res.float().square().mean().sqrt()
