"""Live param / optimizer-state access by name (counterpart of
``deepspeed_tpu/utils/tensor_fragment.py``).

The debugging and EMA APIs that reach through ZeRO's shards
(``safe_get_full_fp32_param``, ``safe_set_full_fp32_param``,
``safe_get_full_optimizer_state``, ``safe_get_full_grad``). Names are
pytree paths like ``"layers/wq"`` or ``"embed"``; values come back as full
numpy arrays whatever the stage: a sharded leaf is all-gathered over the
``fsdp`` axis first, so every rank must make the same calls.
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.serialization import keystr, to_numpy
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.topology import AXIS_FSDP


def _key(name: str) -> str:
    parts = [p for p in name.replace("[", "/").replace("]", "").replace("'", "")
             .split("/") if p]
    return keystr(tuple(parts))


def _index(engine, name: str) -> int:
    key = _key(name)
    try:
        return engine._keys.index(key)
    except ValueError:
        raise KeyError(f"parameter {name!r} not found") from None


def _full(engine, t: torch.Tensor, i: int, sharded: bool) -> np.ndarray:
    if sharded:
        t = comm.all_gather(t.detach(), AXIS_FSDP, gather_dim=engine._lplan[i].dim)
    return to_numpy(t)


def list_param_names(engine) -> list[str]:
    return [k.replace("['", "/").replace("']", "").lstrip("/") for k in engine._keys]


def safe_get_full_fp32_param(engine, name: str) -> np.ndarray:
    """Full (gathered) fp32 master value of a parameter."""
    i = _index(engine, name)
    return _full(engine, engine._leaves[i], i, engine._lplan[i].params_sharded)


@torch.no_grad()
def safe_set_full_fp32_param(engine, name: str, value) -> None:
    """Overwrite a parameter (each rank keeps its block at stage 3); the
    update is visible to the next step."""
    i = _index(engine, name)
    p, lp = engine._leaves[i], engine._lplan[i]
    full = torch.from_numpy(np.asarray(value, dtype=np.float32).reshape(lp.shape))
    if lp.params_sharded:
        full = engine._block_view(full, lp)
    p.copy_(full.to(p.device))


def safe_get_full_optimizer_state(engine, name: str, state_name: str = "mu") -> np.ndarray:
    """Full value of an optimizer moment for a parameter (``exp_avg`` ->
    ``mu``, ``exp_avg_sq`` -> ``nu`` in optax terms; both aliases accepted)."""
    alias = {"exp_avg": "mu", "exp_avg_sq": "nu"}
    state_name = alias.get(state_name, state_name)
    i = _index(engine, name)
    state = engine.opt_state
    values = getattr(state, state_name) if state_name in state._fields else None
    if not isinstance(values, list):
        raise KeyError(f"no optimizer state {state_name!r} found")
    return _full(engine, values[i], i, engine._lplan[i].state_sharded)


@torch.no_grad()
def safe_get_full_grad(engine, name: str) -> np.ndarray | None:
    """The gradient ``backward()`` has accumulated for a parameter since the
    last ``step()`` (the masters' ``.grad``, summed over the ranks, scaled
    by the loss scale as the JAX engine's buffer is); ``None`` outside an
    accumulation: ``train_batch`` consumes its gradients within the step,
    as the JAX engine's fused step does."""
    if not engine._acc_count:
        return None
    from deepspeed_tpu_torch.comm.topology import AXIS_DATA

    i = _index(engine, name)
    p, lp = engine._leaves[i], engine._lplan[i]
    g = p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
    # stage 3: the gather's backward reduce-scattered it over fsdp already
    comm.all_reduce(g, AXIS_DATA if lp.params_sharded else (AXIS_DATA, AXIS_FSDP))
    return _full(engine, g, i, lp.params_sharded)
