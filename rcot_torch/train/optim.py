"""Optimizers of the reference, and its learning-rate schedule.

Counterpart of rcot_tpu/train/optim.py. The reference trains both nets
with torch.optim.RMSprop at its defaults (alpha 0.99, eps 1e-8, no
momentum, not centred) or Adam (betas (0.9, 0.999), eps 1e-8); the JAX
package re-implements exactly these rules, so here they are torch's own.
The learning rate is set on the optimizer before each step (set_lr), as
the JAX package injects it.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Optimizer:
    if name == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8)
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {name!r}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of every group, for the next step."""
    for group in opt.param_groups:
        group["lr"] = lr


def step_decay_lr(base_lr: float, epoch: int, step: int) -> float:
    """lr * 0.1**(epoch // step), epoch 0-based."""
    return base_lr * 0.1 ** (epoch // step)
