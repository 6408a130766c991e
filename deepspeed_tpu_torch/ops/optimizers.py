"""Optimizer registry (counterpart of ``deepspeed_tpu/ops/optimizers.py``).

The JAX package maps the config to an optax transformation; the port keeps
optax's semantics and its shape: ``build_optimizer`` returns a
``GradientTransformation`` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, over the flat list of
parameter leaves. The arithmetic is ``torch._foreach_*`` over that list;
``torch.optim`` is not used, because its Adam orders the steps differently.

``update`` advances the state's moment tensors IN PLACE (the returned state
holds the same tensors), which saves a copy of each moment: the engine
calls it only on a step whose gradients are finite, so an in-place update
never has to be undone. ``updates`` is a new list.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import OptimizerConfig, is_onebit_family


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: int
    mu: list
    nu: list


class TraceState(NamedTuple):
    trace: list


def _zeros(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax ``scale_by_adam``: count += 1; ``mu_hat / (sqrt(nu_hat) + eps)``."""

    def init(params):
        return ScaleByAdamState(count=0, mu=_zeros(params), nu=_zeros(params))

    def update(grads, state, params=None):
        del params
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        denom = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu, _bias_correction(b1, count))
        torch._foreach_div_(updates, denom)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def _with_decoupled_decay_and_lr(inner: GradientTransformation, wd: float,
                                 lr: float) -> GradientTransformation:
    """``chain(inner, add_decayed_weights(wd), scale_by_learning_rate(lr))``:
    the decay reads the params before this step's update."""

    def update(grads, state, params):
        updates, state = inner.update(grads, state, params)
        if wd:
            torch._foreach_add_(updates, params, alpha=wd)
        torch._foreach_mul_(updates, -lr)
        return updates, state

    return GradientTransformation(inner.init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax ``adamw``: Adam, then decoupled weight decay, then the lr."""
    return _with_decoupled_decay_and_lr(scale_by_adam(b1, b2, eps), weight_decay, lr)


def adam_l2(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            weight_decay: float = 0.0) -> GradientTransformation:
    """``chain(add_decayed_weights(wd), adam(lr))``: L2-regularised Adam, the
    decay added to the gradient before the moments see it."""
    inner = _with_decoupled_decay_and_lr(scale_by_adam(b1, b2, eps), 0.0, lr)

    def update(grads, state, params):
        if weight_decay:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        return inner.update(grads, state, params)

    return GradientTransformation(inner.init, update)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> GradientTransformation:
    """optax ``sgd``: ``trace(momentum, nesterov)`` then the lr."""

    def init(params):
        return TraceState(trace=_zeros(params))

    def update(grads, state, params=None):
        del params
        trace = state.trace
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, grads)             # g + decay * t
        if nesterov:
            updates = torch._foreach_mul(trace, momentum)
            torch._foreach_add_(updates, grads)       # g + decay * new_t
        else:
            updates = [t.clone() for t in trace]
        torch._foreach_mul_(updates, -lr)
        return updates, TraceState(trace=trace)

    return GradientTransformation(init, update)


def _adam_args(p: dict) -> dict:
    betas = p.get("betas", (0.9, 0.999))
    return dict(b1=float(betas[0]), b2=float(betas[1]), eps=float(p.get("eps", 1e-8)))


def build_optimizer(cfg: OptimizerConfig, learning_rate: float | None = None
                    ) -> GradientTransformation:
    """Map an ``OptimizerConfig`` to a transformation with optax semantics.

    Ported: adamw, adam (L2 weight decay before Adam), sgd (momentum,
    Nesterov). The rest of the JAX package's registry raises."""
    p = dict(cfg.params)
    lr = float(learning_rate if learning_rate is not None else p.get("lr", 1e-3))
    wd = float(p.get("weight_decay", 0.0))
    t = cfg.type.lower()

    if t == "adamw":
        return adamw(lr, weight_decay=wd, **_adam_args(p))
    if t == "adam":
        return adam_l2(lr, weight_decay=wd, **_adam_args(p))
    if t == "sgd":
        return sgd(lr, momentum=float(p.get("momentum", 0.0)),
                   nesterov=bool(p.get("nesterov", False)))
    if t in ("lion", "lamb", "adagrad", "muon"):
        raise NotImplementedError(
            f"optimizer {cfg.type!r} is not ported yet (ROADMAP.md queue 1 item 15, "
            "the rest of the optimizer registry); adamw, adam and sgd are")
    if is_onebit_family(t):
        raise NotImplementedError(
            f"optimizer {cfg.type!r} belongs to the compressed-communication family, "
            "not ported yet (ROADMAP.md queue 1 item 10)")
    raise ValueError(f"unsupported optimizer type {cfg.type!r}")


def base_lr(cfg: OptimizerConfig) -> float:
    return float(cfg.params.get("lr", 1e-3))
