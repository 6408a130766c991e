"""Mixed precision: bf16 policy + fp16 dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/precision.py``).

The scaler state is a tuple of 0-d tensors on the training device, updated
with ``torch.where``: deciding to grow, shrink or keep the scale needs no
host sync. Semantics are the JAX package's (its ``DynamicLossScaler``):
- overflow: consume hysteresis first; once exhausted, scale = max(scale/2, min)
- ``loss_scale_window`` consecutive good steps: scale *= 2, hysteresis refilled
- a static scale (``loss_scale`` > 0) never changes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    """Device-resident scaler state (all 0-d tensors)."""

    scale: torch.Tensor          # f32 current loss scale
    good_steps: torch.Tensor     # i32 steps since last overflow
    hysteresis: torch.Tensor     # i32 remaining overflow tolerance
    dynamic: torch.Tensor        # bool: static scale never updates


def init_loss_scale(cfg, device="cpu") -> LossScaleState:
    """``cfg``: the config's ``FP16Config``."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    if not cfg.enabled:
        return LossScaleState(f32(1.0), i32(0), i32(1),
                              torch.tensor(False, device=device))
    dynamic = cfg.loss_scale == 0.0
    init = 2.0 ** cfg.initial_scale_power if dynamic else cfg.loss_scale
    return LossScaleState(f32(init), i32(0), i32(cfg.hysteresis),
                          torch.tensor(dynamic, device=device))


def grads_finite(grads) -> torch.Tensor:
    """0-d bool tensor: True iff every element of every gradient is finite."""
    flags = [torch.isfinite(g).all() for g in grads]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def update_loss_scale(state: LossScaleState, finite: torch.Tensor, cfg) -> LossScaleState:
    """Pure update; mirrors the JAX package's ``update_loss_scale``."""
    overflow = torch.logical_not(finite)
    eat_hysteresis = torch.logical_and(overflow, state.hysteresis > 1)
    drop = torch.logical_and(overflow, torch.logical_not(eat_hysteresis))

    new_scale = torch.where(
        drop, torch.clamp(state.scale / 2.0, min=cfg.min_loss_scale), state.scale)
    new_hyst = torch.where(eat_hysteresis, state.hysteresis - 1, state.hysteresis)
    good = torch.where(overflow, torch.zeros_like(state.good_steps), state.good_steps + 1)
    grow = torch.logical_and(finite, good >= cfg.loss_scale_window)
    new_scale = torch.where(grow, new_scale * 2.0, new_scale)
    new_hyst = torch.where(grow, torch.full_like(new_hyst, cfg.hysteresis), new_hyst)
    good = torch.where(grow, torch.zeros_like(good), good)

    # static scale: freeze everything
    return LossScaleState(
        scale=torch.where(state.dynamic, new_scale, state.scale),
        good_steps=torch.where(state.dynamic, good, state.good_steps),
        hysteresis=torch.where(state.dynamic, new_hyst, state.hysteresis),
        dynamic=state.dynamic,
    )


def cast_to_compute(tree, compute_dtype):
    """Cast floating leaves of a nested dict to the compute dtype (the fp32
    master copy stays as it is). The cast is recorded by autograd, so a
    backward through the cast copy accumulates fp32 gradients into the
    masters' ``.grad``; a leaf already in ``compute_dtype`` is returned as
    it is."""
    if isinstance(tree, dict):
        return {k: cast_to_compute(v, compute_dtype) for k, v in tree.items()}
    return tree.to(compute_dtype) if tree.is_floating_point() else tree
