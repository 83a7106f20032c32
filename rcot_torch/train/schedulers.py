"""Learning-rate schedules as plain step -> lr functions; a copy of
rcot_tpu/train/schedulers.py (reference: util/schedulers.py:11-370, a torch
_LRScheduler zoo the reference trainer does not use; it decays by hand,
step_decay_lr in the optim module). Each returns a multiplier of the base LR, or
an absolute LR where base_lr is given:

- multistep_restart: MultiStepRestartLR (milestone gamma decay + restarts)
- linear: LinearLR ramp to zero
- vibrate: VibrateLR (decaying triangle-wave modulation)
- cosine_annealing_restart: CosineAnnealingRestartLR (per-period cosine with
  restart weights)
- cosine_annealing_restart_cyclic: eta_min-per-cycle variant
- linear_warmup_cosine: LinearWarmupCosineAnnealingLR
- linear_warmup_decay: multiplier-style warmup and decay
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def multistep_restart(milestones: Sequence[int], gamma: float = 0.1,
                      restarts: Sequence[int] = (0,),
                      restart_weights: Sequence[float] = (1.0,)) -> Schedule:
    """reference: util/schedulers.py:11-51 (stateful torch scheduler): a
    restart SETS lr = initial * weight and that base persists; milestones
    after the last restart each multiply gamma on. The pure-function
    equivalent: weight of the last restart <= step, times gamma^(milestones
    strictly after that restart, up to step). (A previous version returned
    the restart weight only AT the restart step — wrong for every step
    after it.)"""
    assert len(restarts) == len(restart_weights)
    milestones = sorted(milestones)
    # sort the (restart, weight) pairs: "last restart <= step" must mean
    # largest, not last-listed (milestones above get the same treatment)
    pairs = sorted(zip(restarts, restart_weights))

    def fn(step: int) -> float:
        w, last_r = 1.0, -1
        for r, rw in pairs:
            if r <= step:
                w, last_r = rw, r
        count = sum(1 for m in milestones if last_r < m <= step)
        return w * gamma ** count

    return fn


def linear(total_iter: int) -> Schedule:
    """reference: util/schedulers.py:53-74 — multiplier 1 -> 0 linearly."""
    def fn(step: int) -> float:
        return max(0.0, 1.0 - step / total_iter)
    return fn


def vibrate(total_iter: int) -> Schedule:
    """reference: util/schedulers.py:76-117 — decaying triangle wave.

    f = 0.1 + 0.9 * (1 - step/total); triangle period T = total//80 (>=1),
    first half-period clamped to >= 0.5 * f."""
    def fn(step: int) -> float:
        process = step / total_iter
        f = 0.1 + 0.9 * (1.0 - process)
        t = max(1, total_iter // 80)
        th = t * 4 // 5
        tp = step % t
        w = tp / th if tp < th else 1.0 - (tp - th) / (t - th)
        if step < t // 2:
            w = max(w, 0.5)
        return f * w
    return fn


def _period_index(step: int, cumulative: Sequence[int]) -> int:
    for i, c in enumerate(cumulative):
        if step < c:
            return i
    return len(cumulative) - 1


def _clamp_past_end(step: int, cumulative: Sequence[int]) -> int:
    """Steps past sum(periods) hold at the final eta_min instead of riding
    the cosine back up (the un-clamped argument exceeds pi and the LR
    silently RESURGES to full base_lr at 2x the schedule length). The
    reference raises ValueError there (BasicSR get_position_from_periods);
    holding the floor is the graceful pure-function equivalent."""
    return min(step, cumulative[-1])


def cosine_annealing_restart(periods: Sequence[int],
                             restart_weights: Sequence[float] = (1.0,),
                             eta_min: float = 0.0,
                             base_lr: float = 1.0) -> Schedule:
    """reference: util/schedulers.py:140-188. Returns an absolute LR when
    base_lr is the real LR, else a multiplier."""
    assert len(periods) == len(restart_weights)
    cumulative = [sum(periods[:i + 1]) for i in range(len(periods))]

    def fn(step: int) -> float:
        step = _clamp_past_end(step, cumulative)
        idx = _period_index(step, cumulative)
        w = restart_weights[idx]
        nearest = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        return eta_min + w * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - nearest) / period)))

    return fn


def cosine_annealing_restart_cyclic(periods: Sequence[int],
                                    restart_weights: Sequence[float] = (1.0,),
                                    eta_mins: Sequence[float] = (0.0,),
                                    base_lr: float = 1.0) -> Schedule:
    """reference: util/schedulers.py:190-236 — per-cycle eta_min."""
    assert len(periods) == len(restart_weights)
    cumulative = [sum(periods[:i + 1]) for i in range(len(periods))]

    def fn(step: int) -> float:
        step = _clamp_past_end(step, cumulative)
        idx = _period_index(step, cumulative)
        w = restart_weights[idx]
        eta_min = eta_mins[idx]
        nearest = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        return eta_min + w * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - nearest) / period)))

    return fn


def linear_warmup_cosine(warmup_epochs: int, max_epochs: int,
                         warmup_start_lr: float = 0.0, eta_min: float = 0.0,
                         base_lr: float = 1.0) -> Schedule:
    """reference: util/schedulers.py:239-346."""
    def fn(step: int) -> float:
        if step < warmup_epochs:
            if warmup_epochs == 0:
                return base_lr
            return warmup_start_lr + step * (base_lr - warmup_start_lr) / max(
                1, warmup_epochs - 1)
        progress = (step - warmup_epochs) / max(1, max_epochs - warmup_epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * progress))

    return fn


def linear_warmup_decay(warmup_steps: int, total_steps: int,
                        cosine: bool = True, linear_end: bool = False) -> Schedule:
    """reference: util/schedulers.py:350-370 — multiplier-style warmup+decay."""
    def fn(step: int) -> float:
        if step < warmup_steps:
            return step / max(1, warmup_steps)
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        if linear_end:
            return max(0.0, 1.0 - progress)
        if cosine:
            return 0.5 * (1.0 + math.cos(math.pi * progress))
        return 1.0
    return fn
