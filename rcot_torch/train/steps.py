"""One RCOT minimax training iteration.

Counterpart of rcot_tpu/train/steps.py `make_train_iteration` (its
single-T-forward form; reference trainer.py:247-346):

1. one two-pass T forward with grad; the critic sees out2.detach();
2. critic step 1: the WGAN loss on one batched forward of [target | fake];
3. critic step 2: the gradient penalty at the UPDATED critic;
4. the T loss against the updated critic, differentiated into T's
   parameters only (torch.autograd.grad, so F gathers no grads), and one
   step of T's optimizer at lr / 2.

The state (modules and optimizers) is updated in place. The GP's
interpolation weights `alpha` (B,1,1,1) are an argument, drawn by the
caller from its own generator, so a test can hand in JAX's draw.

`step_inputs` makes one step's batch and alpha from the loader's uint8
patches, every random draw (augment modes, noise, alpha) from
`step_generator(seed, step)`, so a resumed run repeats the uninterrupted
one on the same device (the JAX trainer folds the step into its key the
same way, trainer.py:152-158). In bf16 training (TrainConfig.dtype
"bfloat16") the batch and alpha are bf16, as the JAX trainer's
(trainer.py:145, losses.py:94); the parameters, the optimizer state and
the checkpoints stay fp32, and the losses follow JAX's dtypes (the RMSE
and the Fourier term in fp32, the critic's scores and the GP in bf16).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..data.degradations import augment_and_degrade
from ..models.critic import FNet
from ..models.restormer import TNet
from ..ops.dispatch import resolve_composition
from ..utils.config import Config
from ..utils.device import resolve_device
from .losses import gradient_penalty, t_loss, wgan_critic_loss
from .optim import make_optimizer, set_lr


@dataclass
class TrainState:
    t_net: TNet
    f_net: FNet
    t_opt: torch.optim.Optimizer
    f_opt: torch.optim.Optimizer
    step: int = 0


class Batch(NamedTuple):
    degraded: torch.Tensor  # (B, H, W, C) in [0, 1]
    target: torch.Tensor    # (B, H, W, C) in [0, 1]
    de_id: torch.Tensor     # (B,) int


def create_train_state(cfg: Config, *, seed: Optional[int] = 0, device="cuda",
                       composition: str = "auto", attention_core: str = "gram",
                       depthwise: str = "fused", bwd_bf16="0") -> TrainState:
    """T and F from `seed` (each module's own seeded init; None leaves them
    uninitialised, for a checkpoint to fill), T's optimizer at lr / 2 and
    F's at lr. T's blocks run in `composition` ("auto" is the JAX trainer's
    default, "tail", with either attention core), `attention_core`,
    `depthwise` and `bwd_bf16` (RCOT_BWD_BF16's tiers; ops/dispatch.py)."""
    if cfg.model.backbone != "restormer":
        raise ValueError(f"backbone {cfg.model.backbone!r} is not ported yet")
    dev = resolve_device(device)
    t_net = TNet(cfg.model, device=dev, seed=seed,
                 composition=resolve_composition(composition, training=True),
                 attention_core=attention_core, depthwise=depthwise, bwd_bf16=bwd_bf16)
    f_net = FNet(cfg.critic, device=dev, seed=seed)
    return TrainState(
        t_net=t_net, f_net=f_net,
        t_opt=make_optimizer(cfg.train.optimizer, t_net.parameters(), cfg.train.lr / 2),
        f_opt=make_optimizer(cfg.train.optimizer, f_net.parameters(), cfg.train.lr))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step, keyed by (seed, step)."""
    key = hashlib.sha256(f"{seed}:{step}".encode()).digest()[:8]
    return torch.Generator(device=device).manual_seed(int.from_bytes(key, "little") >> 1)


def batch_dtype(cfg: Config) -> torch.dtype:
    """The dtype of a training batch: TrainConfig.dtype."""
    return torch.bfloat16 if cfg.train.dtype == "bfloat16" else torch.float32


def step_inputs(seed: int, step: int, clean: torch.Tensor, degraded: torch.Tensor,
                de_id: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> Tuple[Batch, torch.Tensor]:
    """uint8 patches (B, P, P, C) and de_id (B,) of one step, on the device
    -> (its Batch, the GP's alpha (B, 1, 1, 1)), in dtype: augment modes,
    noise, then alpha, drawn in that order from step_generator(seed, step)."""
    gen = step_generator(seed, step, clean.device)
    deg, target = augment_and_degrade(clean, degraded, de_id, generator=gen, out_dtype=dtype)
    alpha = torch.rand(clean.shape[0], 1, 1, 1, generator=gen, device=clean.device,
                       dtype=dtype)
    return Batch(deg, target, de_id), alpha


def _step(opt: torch.optim.Optimizer, params: List[torch.nn.Parameter],
          loss: torch.Tensor) -> None:
    """One optimizer step on d loss / d params; a parameter the loss does
    not reach gets a zero gradient, as it does in the JAX package."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()


def make_train_iteration(cfg: Config):
    """-> iteration(state, batch, alpha, paired, lr) -> (state, metrics),
    metrics f_wgan, f_gp, t_loss, t_adv, rmse, fourier, paired_l1 as 0-dim
    tensors on the batch's device."""
    tc = cfg.train

    def iteration(state: TrainState, batch: Batch, alpha: torch.Tensor,
                  paired: bool, lr: float
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        t_params = list(state.t_net.parameters())
        f_params = list(state.f_net.parameters())
        b = batch.target.shape[0]
        with torch.enable_grad():
            out2 = state.t_net(batch.degraded)[0]
            fake = out2.detach()

            set_lr(state.f_opt, lr)
            scores = state.f_net(torch.cat([batch.target, fake], dim=0))
            loss_w = wgan_critic_loss(scores[:b], scores[b:])
            _step(state.f_opt, f_params, loss_w)
            loss_gp = gradient_penalty(state.f_net, batch.target, fake, alpha,
                                       tc.gp_weight)
            _step(state.f_opt, f_params, loss_gp)

            loss, aux = t_loss(out2, batch.degraded, batch.target, batch.de_id,
                               state.f_net(out2), sigma=tc.sigma, Sigma=tc.Sigma,
                               paired=paired, loss_math=tc.loss_math)
            set_lr(state.t_opt, lr / 2)
            _step(state.t_opt, t_params, loss)
        state.step += 1
        metrics = {"f_wgan": loss_w, "f_gp": loss_gp, "t_loss": loss, **aux}
        return state, {k: v.detach() for k, v in metrics.items()}

    return iteration
