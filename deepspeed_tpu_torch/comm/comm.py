"""Collective-communication facade (counterpart of ``deepspeed_tpu/comm/comm.py``).

The JAX package has two families: mesh collectives traced into the step
program (``lax.psum`` and friends over a named axis) and eager host
collectives. The port runs its step eagerly, so both families are eager
``torch.distributed`` calls here:

- ``all_reduce``, ``all_gather``, ``reduce_scatter`` and ``broadcast`` over
  a named mesh axis's process group (``comm/topology.py``), on tensors of
  the engine's device;
- ``barrier``, ``host_broadcast`` and ``host_allgather`` over the world, on
  host numpy data.

Every call is timed into the comms logger when it is on
(``utils/comms_logging.py``): on a CUDA tensor with CUDA events around the
call on the current stream, on the CPU with the host clock.

``init_distributed`` initialises the default process group from the
standard ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
variables (``torchrun``'s): NCCL for a CUDA device, gloo for the CPU. A single process with neither is world 1 with no
process group, and then, and only then, every collective is the identity.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deepspeed_tpu_torch.comm.topology import (MeshTopology, get_topology, reset_topology,
                                               set_topology, topology_initialized)
from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.utils.comms_logging import COMMS_LOGGER
from deepspeed_tpu_torch.utils.logging import log_dist


def _dist():
    import torch.distributed as dist

    return dist


def _group_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


# --------------------------------------------------------------------------- init
def init_distributed(mesh_config: MeshConfig | None = None, device=None) -> MeshTopology:
    """Join (or start) the process group and lay the named mesh over it.

    An initialised default group is used as it is. Otherwise, when the
    environment has ``WORLD_SIZE``, a group starts from ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``): NCCL for a CUDA
    ``device``, gloo otherwise. Without one the process is world 1 with no
    group."""
    dist = _dist()
    dev = torch.device(device) if device is not None else None
    if not _group_initialized() and os.environ.get("WORLD_SIZE") is not None:
        if dev is not None and dev.type == "cuda":
            kw = {"device_id": dev} if dev.index is not None else {}
            dist.init_process_group(backend="nccl", init_method="env://", **kw)
        else:
            dist.init_process_group(backend="gloo", init_method="env://")
        log_dist(f"process group initialized: {dist.get_backend()}, rank "
                 f"{dist.get_rank()} of {dist.get_world_size()}", ranks=[-1])
    if _group_initialized():
        topo = MeshTopology.build(mesh_config or MeshConfig(), dist.get_world_size(),
                                  dist.get_rank(), distributed=True)
    else:
        topo = MeshTopology.build(mesh_config or MeshConfig(), 1, 0, distributed=False)
    set_topology(topo)
    return topo


def destroy_distributed() -> None:
    """End the process group (if any) and forget the topology."""
    if _group_initialized():
        _dist().destroy_process_group()
    reset_topology()


def get_world_size() -> int:
    if _group_initialized():
        return _dist().get_world_size()
    return get_topology().world_size if topology_initialized() else 1


def get_rank() -> int:
    return _dist().get_rank() if _group_initialized() else 0


def _resolve(axis) -> tuple[bool, object, int]:
    """(runs, group, ranks) of a collective over ``axis``: a mesh axis name
    or a tuple of them. ``runs`` is False with no process group (world 1:
    the identity) and for a subgroup of one rank; ``group`` is ``None`` for
    the default group, which serves an axis (or tuple) spanning the world."""
    if not _group_initialized():
        return False, None, 1
    topo = get_topology()
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    n = 1
    for a in axes:
        n *= topo.size(a)
    if n == topo.world_size:
        return True, None, n
    wide = [a for a in axes if topo.size(a) > 1]
    if not wide:
        return False, None, 1
    if len(wide) > 1:
        raise NotImplementedError(f"a collective over {axes} of a {topo.describe()} mesh")
    return True, topo.group(wide[0]), n


def _timed(op_name: str, nbytes: int, n_ranks: int, fn, device):
    """Run ``fn`` and log it: CUDA events on the current stream for a CUDA
    ``device`` (the wait is the logger's, so it costs nothing when the
    logger is off), the host clock otherwise."""
    if not COMMS_LOGGER.enabled:
        return fn()
    if device is not None and device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        seconds = start.elapsed_time(stop) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
    COMMS_LOGGER.append_eager(op_name, nbytes, seconds, n_ranks=n_ranks)
    return out


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


# ------------------------------------------------------------ axis collectives
def all_reduce(x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """In-place reduction of ``x`` over ``axis`` (op: sum, mean, max, min);
    returns ``x``."""
    mean = op == "mean"
    if op not in _REDUCE_OPS and not mean:
        raise ValueError(f"unsupported reduce op {op}")
    runs, group, n = _resolve(axis)
    if not runs:
        return x
    dist = _dist()
    red = getattr(dist.ReduceOp, "SUM" if mean else _REDUCE_OPS[op])
    _timed("all_reduce", x.numel() * x.element_size(), n,
           lambda: dist.all_reduce(x, op=red, group=group), x.device)
    if mean:
        x.div_(n)
    return x


def all_gather(x: torch.Tensor, axis: str, gather_dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``gather_dim``, in axis order
    (``lax.all_gather(..., tiled=True)``)."""
    runs, group, n = _resolve(axis)
    if not runs:
        return x
    dist = _dist()
    src = x.contiguous()
    # the concatenated form [n * d0, ...], which gloo and NCCL both take
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _timed("all_gather", src.numel() * src.element_size(), n,
           lambda: dist.all_gather_into_tensor(out, src, group=group), src.device)
    if gather_dim == 0:
        return out
    shape = list(src.shape)
    shape[gather_dim] *= n
    return out.view((n,) + tuple(src.shape)).movedim(0, gather_dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, axis: str, scatter_dim: int = 0) -> torch.Tensor:
    """Sum ``x`` over ``axis`` and keep this rank's block of ``scatter_dim``
    (``lax.psum_scatter(..., tiled=True)``)."""
    runs, group, n = _resolve(axis)
    if not runs:
        return x
    dist = _dist()
    if x.shape[scatter_dim] % n:
        raise ValueError(f"dim {scatter_dim} of {tuple(x.shape)} not divisible by {n}")
    shape = list(x.shape)
    shape[scatter_dim] //= n
    src = x.reshape(shape[:scatter_dim] + [n] + shape[scatter_dim:]).movedim(
        scatter_dim, 0).reshape([n * shape[0]] + shape[1:])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _timed("reduce_scatter", out.numel() * out.element_size(), n,
           lambda: dist.reduce_scatter_tensor(out, src, group=group), x.device)
    return out


def broadcast(x: torch.Tensor, axis: str, src_index: int = 0) -> torch.Tensor:
    """In-place: every rank on ``axis`` takes the ``src_index``-th rank's ``x``."""
    runs, group, n = _resolve(axis)
    if not runs:
        return x
    dist = _dist()
    src = (dist.get_global_rank(group, src_index) if group is not None else src_index)
    _timed("broadcast", x.numel() * x.element_size(), n,
           lambda: dist.broadcast(x, src=src, group=group), x.device)
    return x


# ------------------------------------------------------------ host collectives
def barrier(name: str = "barrier") -> None:
    """Process-level barrier over the world."""
    del name
    if not _group_initialized() or _dist().get_world_size() <= 1:
        return
    _timed("barrier", 0, _dist().get_world_size(), lambda: _dist().barrier(), None)


def host_broadcast(value, is_source: bool | None = None):
    """Broadcast picklable host data from rank 0 to every rank."""
    del is_source
    if not _group_initialized() or _dist().get_world_size() <= 1:
        return value
    box = [value]
    _timed("broadcast", int(np.asarray(value).nbytes) if isinstance(value, np.ndarray) else 0,
           _dist().get_world_size(), lambda: _dist().broadcast_object_list(box, src=0), None)
    return box[0]


def host_allgather(value) -> np.ndarray:
    """Every rank's ``value`` stacked along a new leading axis, in rank order."""
    value = np.asarray(value)
    if not _group_initialized() or _dist().get_world_size() <= 1:
        return value[None]
    out = [None] * _dist().get_world_size()
    _timed("all_gather", int(value.nbytes), len(out),
           lambda: _dist().all_gather_object(out, value), None)
    return np.stack(out)


def configure(comms_config) -> None:
    """Wire the comms logger config (reference ``dist.configure``)."""
    COMMS_LOGGER.configure(comms_config)


def log_summary(show_straggler: bool = False) -> str:
    text = COMMS_LOGGER.log_summary(show_straggler=show_straggler)
    from deepspeed_tpu_torch.telemetry import TELEMETRY

    if TELEMETRY.enabled:
        TELEMETRY.event("comm/summary", text=text)
    return text
