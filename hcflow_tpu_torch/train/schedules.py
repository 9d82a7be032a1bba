"""Learning-rate schedules as plain functions of the iteration step, as
``hcflow_tpu/train/schedules.py`` (the reference's MultiStepLR_Restart and
CosineAnnealingLR_Restart, linear warm-up, and the steps at which ``clear_state``
resets the optimizer moments)."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def multistep_restart(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.5,
    restarts: Optional[Sequence[int]] = None,
    restart_weights: Optional[Sequence[float]] = None,
):
    """lr = base * gamma^(milestones passed); at a restart the base is scaled by the
    restart's weight and only the milestones after the restart decay it."""
    milestones = list(milestones) if milestones else []
    restarts = list(restarts) if restarts else []
    restart_weights = list(restart_weights) if restart_weights else [1.0] * len(restarts)

    def schedule(step):
        step = int(step)
        lr = base_lr * gamma ** sum(step >= m for m in milestones)
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                lr = base_lr * w * gamma ** sum(m > r and step >= m for m in milestones)
        return lr

    return schedule


def cosine_restart(
    base_lr: float,
    periods: Sequence[int],
    eta_min: float = 1e-8,
    restart_weights: Optional[Sequence[float]] = None,
):
    """Cosine annealing over successive periods with per-restart weights."""
    periods = list(periods)
    restart_weights = list(restart_weights) if restart_weights else [1.0] * len(periods)
    starts = [0]
    for p in periods[:-1]:
        starts.append(starts[-1] + p)

    def schedule(step):
        step = float(step)
        lr = eta_min
        for start, period, w in zip(starts, periods, restart_weights):
            if step >= start:
                t = min(max((step - start) / period, 0.0), 1.0)
                lr = eta_min + 0.5 * (base_lr * w - eta_min) * (1 + math.cos(math.pi * t))
        return lr

    return schedule


def with_warmup(schedule, warmup_iter: int):
    """Linear warm-up over the first warmup_iter steps."""

    def warmed(step):
        return schedule(step) * min(max(float(step) / max(warmup_iter, 1), 0.0), 1.0)

    return warmed


def restart_steps(train_opt: dict):
    """Steps at which ``clear_state`` resets the optimizer moments: each restart + 1
    (the reference stores restarts shifted by one); for the cosine scheme without
    explicit restarts, the cumulative ``T_period`` boundaries + 1."""
    if not train_opt.get("clear_state"):
        return frozenset()
    restarts = train_opt.get("restarts") or []
    if restarts:
        return frozenset(int(r) + 1 for r in restarts)
    if train_opt.get("lr_scheme") == "CosineAnnealingLR_Restart":
        acc, steps = 0, []
        for p in list(train_opt.get("T_period") or [])[:-1]:
            acc += p
            steps.append(acc + 1)
        return frozenset(steps)
    return frozenset()


def schedule_from_opt(train_opt: dict):
    """The configured schedule of a parsed ``train`` option section."""
    base_lr = train_opt.get("lr_G", 2.5e-4)
    if train_opt.get("lr_scheme", "MultiStepLR") == "CosineAnnealingLR_Restart":
        sched = cosine_restart(
            base_lr,
            train_opt.get("T_period", [train_opt.get("niter", 100000)]),
            eta_min=train_opt.get("eta_min", 1e-8),
            restart_weights=train_opt.get("restart_weights"),
        )
    else:
        sched = multistep_restart(
            base_lr,
            train_opt.get("lr_steps") or [],
            gamma=train_opt.get("lr_gamma", 0.5),
            restarts=train_opt.get("restarts"),
            restart_weights=train_opt.get("restart_weights"),
        )
    warmup = train_opt.get("warmup_iter") or 0
    if warmup and warmup > 0:
        sched = with_warmup(sched, warmup)
    return sched
