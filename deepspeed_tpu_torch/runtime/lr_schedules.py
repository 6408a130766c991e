"""Learning-rate schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

Each schedule is a plain Python function ``step (int) -> lr (float)``. The
JAX package computes them inside its compiled step; here the engine calls
one per step on the host and scales the optimizer's updates by the result,
so nothing about the schedule ever reaches the device but one float.

Semantics are the JAX package's, formula for formula:
- warmup ``log``: gamma = log(step+1)/log(warmup_num_steps), clamped at 1
- warmup ``linear``: gamma = step/warmup_num_steps
- WarmupDecayLR: linear decay to 0 at total_num_steps after warmup
- WarmupCosineLR: ratios scale the optimizer's base lr; cosine progress clamped
  to [0,1] so the lr parks at ``cos_min_ratio`` past the end
- OneCycle: triangular cycle then exponential decay
- LRRangeTest: continuous or staircase geometric ramp
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def _warmup_gamma(step, warmup_num_steps: int, warmup_type: str) -> float:
    """``WarmupLR._get_gamma``: ramp factor in [0, 1]."""
    warmup_num_steps = max(2, int(warmup_num_steps))
    step_f = float(step)
    if warmup_type == WARMUP_LOG_RATE:
        gamma = math.log(step_f + 1.0) / math.log(warmup_num_steps)
    elif warmup_type == WARMUP_LINEAR_RATE:
        gamma = step_f / warmup_num_steps
    else:
        raise ValueError(f"unknown warmup_type {warmup_type!r} (log|linear)")
    return _clip(gamma, 0.0, 1.0)


def warmup_lr(
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 0.001,
    warmup_num_steps: int = 1000,
    warmup_type: str = WARMUP_LOG_RATE,
) -> Schedule:
    """``WarmupLR``: min -> max over warmup steps, then constant."""

    def schedule(step):
        gamma = _warmup_gamma(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(
    total_num_steps: int,
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 0.001,
    warmup_num_steps: int = 1000,
    warmup_type: str = WARMUP_LOG_RATE,
) -> Schedule:
    """``WarmupDecayLR``: warmup, then linear decay to 0 at total steps."""
    wns = max(2, int(warmup_num_steps))

    def schedule(step):
        step_f = float(step)
        if step_f < wns:
            gamma = _warmup_gamma(step, wns, warmup_type)
        else:
            gamma = max(0.0, (total_num_steps - step_f)
                        / max(1.0, float(total_num_steps - wns)))
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_cosine_lr(
    total_num_steps: int,
    base_lr: float,
    warmup_min_ratio: float = 0.0,
    warmup_num_steps: int = 1000,
    cos_min_ratio: float = 0.0001,
    warmup_type: str = WARMUP_LOG_RATE,
) -> Schedule:
    """``WarmupCosineLR``: ratio ramps warmup_min_ratio -> 1, then cosine to
    cos_min_ratio; multiplies the optimizer's base lr."""
    wns = max(2, int(warmup_num_steps))

    def schedule(step):
        step_f = float(step)
        if step_f < wns:
            ramp = _warmup_gamma(step, wns, warmup_type)
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * ramp
        else:
            real_last = step_f - wns + 1.0
            real_total = max(1, total_num_steps - wns)
            progress = _clip(real_last / real_total, 0.0, 1.0)
            cos_ratio = cos_min_ratio + (1.0 - cos_min_ratio) * (
                1.0 + math.cos(math.pi * progress)) / 2.0
            ratio = max(0.0, cos_ratio)
        return base_lr * ratio

    return schedule


def one_cycle(
    cycle_min_lr: float,
    cycle_max_lr: float,
    cycle_first_step_size: int = 2000,
    cycle_second_step_size: int | None = None,
    decay_step_size: int = 0,
    decay_lr_rate: float = 0.0,
) -> Schedule:
    """``OneCycle`` (lr part): triangular up over the first phase, down over
    the second, then exponential decay every ``decay_step_size`` steps."""
    second = cycle_first_step_size if cycle_second_step_size is None else cycle_second_step_size
    total_size = float(cycle_first_step_size + second)
    step_ratio = cycle_first_step_size / total_size

    def schedule(step):
        it = float(step)
        if it < total_size - 1.0:
            cycle = math.floor(1.0 + it / total_size)
            x = 1.0 + it / total_size - cycle
            scale = x / step_ratio if x <= step_ratio else (x - 1.0) / (step_ratio - 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * scale
        if decay_step_size > 0 and decay_lr_rate > 0.0:
            decay_it = it - total_size + 1.0
            decay_cycles = math.floor(1.0 + decay_it / decay_step_size)
            return cycle_min_lr * (1.0 / (1.0 + decay_lr_rate)) ** (decay_cycles - 1.0)
        return cycle_min_lr

    return schedule


def lr_range_test(
    lr_range_test_min_lr: float = 0.001,
    lr_range_test_step_size: int = 2000,
    lr_range_test_step_rate: float = 1.0,
    lr_range_test_staircase: bool = False,
) -> Schedule:
    """``LRRangeTest``: lr = min_lr * (1 + rate * interval(step))."""

    def schedule(step):
        interval = (float(step) + 1.0) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + lr_range_test_step_rate * interval)

    return schedule


def constant_lr(lr: float) -> Schedule:
    def schedule(step):
        del step
        return float(lr)

    return schedule


# ----------------------------------------------------------------- factory
VALID_SCHEDULES = ("WarmupLR", "WarmupDecayLR", "WarmupCosineLR", "OneCycle", "LRRangeTest")


def build_schedule(scheduler_config, base_lr: float) -> Schedule:
    """Build a schedule from a ``SchedulerConfig`` (type + params dict).

    ``base_lr`` is the optimizer lr, used by WarmupCosineLR (ratio-based) and as
    the fallback when no scheduler is configured.
    """
    if scheduler_config is None:
        return constant_lr(base_lr)
    name, params = scheduler_config.type, dict(scheduler_config.params)
    if name == "WarmupLR":
        return warmup_lr(**params)
    if name == "WarmupDecayLR":
        return warmup_decay_lr(**params)
    if name == "WarmupCosineLR":
        return warmup_cosine_lr(base_lr=base_lr, **params)
    if name == "OneCycle":
        allowed = {
            "cycle_min_lr", "cycle_max_lr", "cycle_first_step_size",
            "cycle_second_step_size", "decay_step_size", "decay_lr_rate",
        }
        return one_cycle(**{k: v for k, v in params.items() if k in allowed})
    if name == "LRRangeTest":
        return lr_range_test(**params)
    raise ValueError(f"unknown scheduler type {name!r}; valid: {VALID_SCHEDULES}")


class LRScheduler:
    """Stateful wrapper with the scheduler protocol
    (``step()``, ``get_last_lr()``, ``state_dict()``/``load_state_dict()``)."""

    def __init__(self, schedule: Schedule, last_batch_iteration: int = -1):
        self.schedule = schedule
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration: int | None = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_last_lr(self):
        return [float(self.schedule(max(0, self.last_batch_iteration)))]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
