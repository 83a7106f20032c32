"""Loss math for the RCOT minimax.

Counterpart of rcot_tpu/train/losses.py; reference trainer.py:266-343.

Transport map (T):
    T_loss = -mean(F(T(x)))
             + sigma * ( sqrt(mean(res^2)) + fourier_residual_penalty(res, de_id) )
             + [ Sigma * mean|T(x) - y|   in the paired phase ]
with res = x - T(x).

Critic (F):
    F_loss = -mean(F(y)) + mean(F(T(x).detach()))
    GP     = 10 * mean((||dF/dx_hat||_2 - 1)^2),  x_hat = a*y + (1-a)*T(x)
The caller draws the interpolation weights a (B,1,1,1) from its own
generator and passes them in.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops.fourier import fourier_residual_penalty, residual_rmse


def t_loss(out: torch.Tensor, inp: torch.Tensor, target: torch.Tensor,
           de_id: torch.Tensor, critic_score: torch.Tensor, *, sigma: float,
           Sigma: float, paired: bool, loss_math: str = "reference"
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Transport-map loss and its parts (t_adv, rmse, fourier, paired_l1)."""
    res = inp - out
    rmse = residual_rmse(res)
    fourier = fourier_residual_penalty(res, de_id, loss_math)
    adv = -critic_score.mean()
    paired_l1 = (out - target).abs().mean()
    loss = adv + sigma * (rmse + fourier)
    if paired:
        loss = loss + Sigma * paired_l1
    return loss, {"t_adv": adv, "rmse": rmse, "fourier": fourier,
                  "paired_l1": paired_l1}


def wgan_critic_loss(score_real: torch.Tensor, score_fake: torch.Tensor) -> torch.Tensor:
    """-mean F(real) + mean F(fake)."""
    return -score_real.mean() + score_fake.mean()


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, weight: float = 10.0) -> torch.Tensor:
    """WGAN-GP on per-sample interpolates; critic_fn: x (B,H,W,C) -> (B,).
    The norm is over all non-batch dims. The input gradient keeps its
    graph, so the result differentiates into the critic's parameters."""
    b = real.shape[0]
    with torch.enable_grad():
        x_hat = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_()
        (grads,) = torch.autograd.grad(critic_fn(x_hat).sum(), x_hat,
                                       create_graph=True)
        norms = grads.reshape(b, -1).square().sum(dim=1).sqrt()
        return weight * (norms - 1.0).square().mean()
