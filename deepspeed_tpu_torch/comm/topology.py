"""Named process-mesh topology (counterpart of ``deepspeed_tpu/comm/topology.py``).

The JAX package builds one ``jax.sharding.Mesh`` with named axes; the port
lays the same named axes over the ranks of the ``torch.distributed`` world,
in the same axis order (pipeline, data, fsdp, expert, sequence, tensor;
the last varies fastest), and hands out one process group per axis: the
ranks that differ only in that axis's coordinate.

Axis semantics are the JAX package's:
  data      pure data parallel (batch split, grads averaged)
  fsdp      ZeRO axis (batch split AND param/grad/opt-state sharding)
  tensor    tensor (model) parallel
  sequence  Ulysses/ring sequence parallel
  expert    MoE expert parallel
  pipeline  pipeline stages

This slice runs the ``data`` and ``fsdp`` axes; the engine refuses the
others above 1 (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.utils.logging import log_dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "sequence"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipeline"
ALL_AXES = (AXIS_PIPE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)
# axes whose ranks consume distinct batch elements (the batch triangle's DP world)
BATCH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)


def resolve_sizes(cfg: MeshConfig, n: int) -> dict:
    """Axis sizes for a world of ``n`` ranks; ``data: -1`` takes the rest.
    Raises ``ValueError`` as ``MeshTopology.build`` does in the JAX package
    when the sizes do not make up the world."""
    sizes = {
        AXIS_DATA: cfg.data,
        AXIS_FSDP: cfg.fsdp,
        AXIS_TENSOR: cfg.tensor,
        AXIS_SEQ: cfg.sequence,
        AXIS_EXPERT: cfg.expert,
        AXIS_PIPE: cfg.pipeline,
    }
    fixed = math.prod(v for v in sizes.values() if v > 0)
    if sizes[AXIS_DATA] == -1:
        rest = math.prod(sizes[a] for a in ALL_AXES if a != AXIS_DATA)
        if n % rest:
            raise ValueError(
                f"{n} devices not divisible by non-data axes product {rest} ({sizes})")
        sizes[AXIS_DATA] = n // rest
    elif fixed != n:
        raise ValueError(f"Mesh axes product {fixed} != device count {n} ({sizes})")
    return sizes


@dataclass
class MeshTopology:
    """Axis sizes, this rank's coordinates and one process group per axis.

    ``groups[axis]`` is ``None`` when the axis spans the whole world (the
    default group serves it) and when no process group is initialised;
    otherwise the subgroup of this rank's axis neighbours. ``distributed``
    says whether a process group is initialised (a single process without
    one is world 1, where every collective is the identity)."""

    sizes: dict
    rank: int = 0
    distributed: bool = False
    groups: dict = field(default_factory=dict)

    @classmethod
    def build(cls, cfg: MeshConfig, world_size: int = 1, rank: int = 0,
              distributed: bool = False) -> "MeshTopology":
        sizes = resolve_sizes(cfg, world_size)
        topo = cls(sizes=sizes, rank=rank, distributed=distributed)
        if distributed:
            topo.groups = _axis_groups(sizes, rank)
        log_dist(f"Mesh built: {topo.describe()}", ranks=[0])
        return topo

    # ------------------------------------------------------------ accessors
    def size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def dp_world_size(self) -> int:
        """Ranks consuming distinct batch elements (data * fsdp * expert)."""
        return math.prod(self.sizes[a] for a in BATCH_AXES)

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in BATCH_AXES if self.sizes[a] > 1) or (AXIS_DATA,)

    def describe(self) -> str:
        active = {a: s for a, s in self.sizes.items() if s > 1} or {AXIS_DATA: 1}
        return f"{self.world_size} devices as {active}"

    def coords(self, rank: int | None = None) -> dict:
        """Axis -> coordinate of ``rank`` (this rank by default)."""
        shape = [self.sizes[a] for a in ALL_AXES]
        idx = np.unravel_index(self.rank if rank is None else rank, shape)
        return {a: int(i) for a, i in zip(ALL_AXES, idx)}

    def coord(self, axis: str) -> int:
        return self.coords()[axis]

    def batch_index(self) -> int:
        """This rank's slot among the ``dp_world_size`` batch shards: its
        (data, fsdp, expert) coordinates in row-major order, the order in
        which a dim-0 batch sharding over those axes deals out rows."""
        c = self.coords()
        i = 0
        for a in BATCH_AXES:
            i = i * self.sizes[a] + c[a]
        return i

    def group(self, axis: str):
        return self.groups.get(axis)


def _axis_groups(sizes: dict, rank: int) -> dict:
    """One ``torch.distributed`` subgroup per axis of size > 1 that does not
    span the world. Every rank creates every group, in the same order, as
    ``new_group`` requires; each keeps the ones it belongs to."""
    import torch.distributed as dist

    shape = [sizes[a] for a in ALL_AXES]
    ranks = np.arange(math.prod(shape)).reshape(shape)
    world = ranks.size
    mine = {}
    for i, axis in enumerate(ALL_AXES):
        if sizes[axis] in (1, world):
            continue
        lines = np.moveaxis(ranks, i, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine[axis] = g
    return mine


_topology: MeshTopology | None = None


def set_topology(topo: MeshTopology) -> None:
    global _topology
    _topology = topo


def get_topology() -> MeshTopology:
    if _topology is None:
        raise RuntimeError(
            "Mesh topology not initialized — call initialize()/init_distributed() first")
    return _topology


def topology_initialized() -> bool:
    return _topology is not None


def reset_topology() -> None:
    """Forget the process-global topology (test harness API); the process
    group itself stays (``comm.destroy_distributed`` ends it)."""
    global _topology
    _topology = None
