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

gan_loss and tv_loss are the reference's helpers that its main path does
not call (util/loss_utils.py:6-45, utils.py:59-72).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops.fourier import fourier_residual_penalty, residual_rmse


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at 0, +1 (jnp.abs; torch.abs takes 0 there).
    In bf16 out == target ties are common, and the paired term's weight
    (Sigma = 1e4) makes each one count."""
    return torch.where(x >= 0, x, -x)


def t_loss(out: torch.Tensor, inp: torch.Tensor, target: torch.Tensor,
           de_id: torch.Tensor, critic_score: torch.Tensor, *, sigma: float,
           Sigma: float, paired: bool, loss_math: str = "reference"
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Transport-map loss and its parts (t_adv, rmse, fourier, paired_l1)."""
    res = inp - out
    rmse = residual_rmse(res)
    fourier = fourier_residual_penalty(res, de_id, loss_math)
    adv = -critic_score.mean()
    paired_l1 = _abs(out - target).mean()
    loss = adv + sigma * (rmse + fourier)
    if paired:
        # Sigma in paired_l1's dtype, as JAX takes the Python float (1e4 is
        # 9984 in bf16)
        loss = loss + float(torch.tensor(Sigma).to(paired_l1.dtype)) * paired_l1
    return loss, {"t_adv": adv, "rmse": rmse, "fourier": fourier,
                  "paired_l1": paired_l1}


def wgan_critic_loss(score_real: torch.Tensor, score_fake: torch.Tensor) -> torch.Tensor:
    """-mean F(real) + mean F(fake)."""
    return -score_real.mean() + score_fake.mean()


def gan_loss(scores: torch.Tensor, target_is_real: bool,
             mode: str = "lsgan") -> torch.Tensor:
    """The reference's GANLoss: 'lsgan' = MSE to 1/0 labels, 'vanilla' =
    BCE with logits, 'wgan' = -/+ mean score."""
    if mode == "lsgan":
        target = torch.ones_like(scores) if target_is_real else torch.zeros_like(scores)
        return (scores - target).square().mean()
    if mode == "vanilla":
        target = torch.ones_like(scores) if target_is_real else torch.zeros_like(scores)
        return (scores.clamp(min=0) - scores * target
                + torch.log1p(torch.exp(-scores.abs()))).mean()
    if mode == "wgan":
        return -scores.mean() if target_is_real else scores.mean()
    raise ValueError(f"unknown gan loss mode {mode!r}")


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation of (B, H, W, C): the per-element means of squared
    forward differences over height and over width, summed, times 2, over
    the batch (the standard TVLoss the reference derives from).

    A deliberate deviation, as in the JAX package: the reference's copy
    (utils.py:59-72, dead on its main path) squeezes to CHW but keeps 4-D
    indexing, so its 'h_tv' differences channels and its 'w_tv' height.
    This is the math the snippet intends."""
    b, h, w, c = x.shape
    dh = (x[:, 1:] - x[:, :-1]).square().sum()
    dw = (x[:, :, 1:] - x[:, :, :-1]).square().sum()
    return weight * 2.0 * (dh / (c * (h - 1) * w) + dw / (c * h * (w - 1))) / b


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
