"""Elastic training: batch-size-compatible world-size math (counterpart of
``deepspeed_tpu/elasticity/elasticity.py``).

Given a target effective batch size and candidate micro-batch sizes, the
set of admissible accelerator counts, so a job can restart at a different
scale with the same batch math. Recovery is checkpoint-based: the
universal-layout checkpoints (``checkpoint/``) load at any admissible world
size.
"""

from __future__ import annotations

from dataclasses import dataclass

from deepspeed_tpu_torch.config.base import ConfigError


def get_compatible_world_sizes(
    batch_size: int, micro_batches: list[int], min_world: int, max_world: int
) -> list[int]:
    """World sizes w for which some micro-batch m gives batch = m * gas * w
    exactly (reference ``_get_compatible_gpus_v01``)."""
    valid = set()
    for w in range(min_world, max_world + 1):
        for m in micro_batches:
            if batch_size % (m * w) == 0:
                valid.add(w)
                break
    return sorted(valid)


@dataclass
class ElasticConfig:
    final_batch_size: int
    valid_world_sizes: list[int]
    micro_batch_per_world: dict[int, int]


def compute_elastic_config(
    target_batch_size: int,
    micro_batches: list[int],
    max_world_size: int,
    min_world_size: int = 1,
    prefer_larger_batch: bool = True,
) -> ElasticConfig:
    """Pick an effective batch near the target that maximizes admissible world
    sizes (reference ``compute_elastic_config:233``, v0.1 semantics)."""
    if not micro_batches:
        raise ConfigError("elasticity: micro_batches must be non-empty")
    candidates = sorted(
        range(max(1, target_batch_size // 2), target_batch_size * 2 + 1),
        key=lambda b: (-len(get_compatible_world_sizes(b, micro_batches, min_world_size, max_world_size)),
                       abs(b - target_batch_size),
                       -b if prefer_larger_batch else b),
    )
    best = candidates[0]
    valid = get_compatible_world_sizes(best, micro_batches, min_world_size, max_world_size)
    if not valid:
        raise ConfigError(
            f"elasticity: no world size in [{min_world_size}, {max_world_size}] "
            f"is compatible with batch {target_batch_size} and micros {micro_batches}"
        )
    micro_per_world = {}
    for w in valid:
        for m in sorted(micro_batches, reverse=True):
            if best % (m * w) == 0:
                micro_per_world[w] = m
                break
    return ElasticConfig(final_batch_size=best, valid_world_sizes=valid,
                         micro_batch_per_world=micro_per_world)


def ensure_immutable_elastic_config(runtime_config: dict, frozen: dict) -> None:
    """Elastic params may not change across restarts (reference
    ``ensure_immutable_elastic_config:208``)."""
    for key, expected in frozen.items():
        actual = runtime_config.get(key)
        if actual != expected:
            raise ConfigError(
                f"elastic config field {key!r} changed across restart: "
                f"{expected!r} -> {actual!r}"
            )
