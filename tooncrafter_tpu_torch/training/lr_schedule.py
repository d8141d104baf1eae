"""LR schedules as functions of the optimizer step
(tooncrafter_tpu/training/lr_schedule.py, which builds them from optax).

Each schedule maps the number of updates already applied to a learning
rate, with optax's semantics: a linear warmup and a cosine decay that hold
their end values past their last step. ``lambda_lr`` adapts one to
``torch.optim.lr_scheduler.LambdaLR`` over an optimizer whose base
learning rate is 1.0.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda step: float(value)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over transition_steps, then end
    (init throughout when transition_steps <= 0)."""
    def fn(step: int) -> float:
        if transition_steps <= 0:
            return float(init_value)
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return fn


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: the i-th schedule from boundaries[i-1] on,
    counting from its boundary."""
    def fn(step: int) -> float:
        start = 0
        for sched, bound in zip(schedules, boundaries):
            if step < bound:
                return sched(step - start)
            start = bound
        return schedules[-1](step - start)
    return fn


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) cos-ramp + alpha)."""
    def fn(step: int) -> float:
        count = min(max(step, 0), decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return fn


def warmup_schedule(base_lr: float, warmup_steps: int,
                    start_factor: float = 0.0) -> Schedule:
    """Linear ramp from start_factor*base_lr to base_lr over warmup_steps,
    then constant."""
    return join_schedules([
        linear_schedule(base_lr * start_factor, base_lr, warmup_steps),
        constant_schedule(base_lr)], [warmup_steps])


def cosine_schedule(base_lr: float, decay_steps: int, warmup_steps: int = 0,
                    final_factor: float = 0.0) -> Schedule:
    if warmup_steps > 0:
        # optax.warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
        # decay_steps, base_lr * final_factor)
        return join_schedules([
            linear_schedule(0.0, base_lr, warmup_steps),
            cosine_decay_schedule(base_lr, decay_steps - warmup_steps,
                                  final_factor)], [warmup_steps])
    return cosine_decay_schedule(base_lr, decay_steps, final_factor)


def from_config(base_lr: float, scheduler_cfg: dict) -> Schedule:
    """Resolve the reference's scheduler YAML (`target` + params)."""
    target = scheduler_cfg.get("target", "")
    p = scheduler_cfg.get("params", {})
    if "LambdaLRScheduler" in target or "lambda" in target.lower():
        return warmup_schedule(base_lr, p.get("num_warmup_steps",
                                              p.get("warm_up_steps", 1000)))
    if "Cosine" in target:
        return cosine_schedule(base_lr, p.get("decay_steps", 100000),
                               p.get("warm_up_steps", 0),
                               p.get("final_factor", 0.0))
    return constant_schedule(base_lr)


def lambda_lr(optimizer, schedule: Schedule):
    """A LambdaLR that sets the absolute learning rate ``schedule(n)``
    before update n: the optimizer's base learning rate must be 1.0."""
    import torch

    for group in optimizer.param_groups:
        if group.get("initial_lr", group["lr"]) != 1.0:
            raise ValueError("lambda_lr needs an optimizer built with lr=1.0")
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
