"""Sharding planner: ZeRO stages over the ``fsdp`` axis (counterpart of
``deepspeed_tpu/parallel/partition.py``).

Stage semantics are the JAX package's (``partition.py:17-21``):
  0: params/grads/opt-state replicated (pure DP; grads all-reduced)
  1: opt-state sharded
  2: + grads sharded (all-reduce -> reduce-scatter at the accumulation boundary)
  3: + params sharded (all-gather on use, per layer)

The JAX package states them as ``PartitionSpec`` trees and lets XLA insert
the collectives; the port keeps the same per-leaf decision as a tuple of
mesh-axis names (or ``None``) per dimension and runs the collectives itself
(``runtime/engine.py``). ``_spec_for_param`` is the reference's rule for the
``fsdp`` axis, so a fragment's box in a checkpoint means the same thing in
both packages: the leaf's largest dimension that the axis divides, never
``layers`` or ``experts``, and only for leaves above
``persistence_threshold`` elements. One difference: the port names that
dimension when the ``fsdp`` axis has size 1 too (the reference leaves such
a leaf replicated). A one-way shard is the whole leaf, so the values, the
boxes on disk and the collectives' results are the same; the engine then
runs the stage's collectives and its stage-3 gather on one rank as well.
Tensor parallelism, pipelines and hpZ are not ported (ROADMAP.md queue 1
items 10 and 12).
"""

from __future__ import annotations

from dataclasses import dataclass

from deepspeed_tpu_torch.comm.topology import AXIS_FSDP, MeshTopology

# Axes the fsdp planner may not claim.
_FSDP_EXCLUDED = {"layers", "experts"}


def _spec_for_param(axes: tuple, shape: tuple, topo: MeshTopology,
                    persistence_threshold: int) -> tuple:
    """Per-dimension mesh axis (or ``None``) of one leaf's fully sharded layout."""
    assign: list = [None] * len(shape)
    size = 1
    for s in shape:
        size *= s
    fsdp = topo.size(AXIS_FSDP)
    if size > persistence_threshold:
        candidates = [i for i in range(len(shape))
                      if axes[i] not in _FSDP_EXCLUDED and shape[i] % fsdp == 0]
        if candidates:
            assign[max(candidates, key=lambda i: shape[i])] = AXIS_FSDP
    return tuple(assign)


def shard_dim(spec: tuple) -> int | None:
    """The dimension a spec shards over ``fsdp``, or ``None``."""
    for i, a in enumerate(spec):
        if a == AXIS_FSDP:
            return i
    return None


@dataclass
class LeafPlan:
    """One leaf's layout: ``dim`` is the dimension its fully sharded layout
    splits over ``fsdp`` (``None``: replicated at every stage); the three
    flags say which of params, gradients and optimizer state are sharded at
    this stage."""

    key: str
    shape: tuple
    dim: int | None
    params_sharded: bool
    grads_sharded: bool
    state_sharded: bool

    def bounds(self, index: int, parts: int) -> tuple[int, int]:
        """[start, stop) of block ``index`` of ``parts`` along ``dim``."""
        n = self.shape[self.dim] // parts
        return index * n, (index + 1) * n

    def box(self, index: int, parts: int) -> list[list[int]]:
        """The checkpoint box (``[[start, stop], ...]``) of block ``index``."""
        out = [[0, d] for d in self.shape]
        if self.dim is not None:
            out[self.dim] = list(self.bounds(index, parts))
        return out


@dataclass
class ShardingPlan:
    """Per-leaf layouts, keyed by the leaf's ``keystr`` path
    (``"['layers']['wq']"``), in the params' leaf order."""

    topo: MeshTopology
    zero_stage: int
    leaves: dict

    def __iter__(self):
        return iter(self.leaves.values())


def plan_sharding(logical_axes: dict, shapes: dict, topo: MeshTopology,
                  zero_stage: int = 0, persistence_threshold: int = 0) -> ShardingPlan:
    """Plan every leaf. ``logical_axes`` and ``shapes``: ``keystr`` path ->
    tuple of logical axis names / the leaf's shape."""
    if set(logical_axes) != set(shapes):
        raise ValueError(
            f"logical_axes ({len(logical_axes)} leaves) does not match params "
            f"({len(shapes)} leaves): {sorted(set(logical_axes) ^ set(shapes))}")
    leaves = {}
    for key, shape in shapes.items():
        spec = _spec_for_param(tuple(logical_axes[key]), tuple(shape), topo,
                               persistence_threshold)
        dim = shard_dim(spec)
        sharded = dim is not None
        leaves[key] = LeafPlan(key=key, shape=tuple(shape), dim=dim,
                               params_sharded=sharded and zero_stage >= 3,
                               grads_sharded=sharded and zero_stage >= 2,
                               state_sharded=sharded and zero_stage >= 1)
    return ShardingPlan(topo=topo, zero_stage=zero_stage, leaves=leaves)
