"""Model contract (counterpart of ``deepspeed_tpu/models/api.py:282 ModelSpec``)
and the causal-LM loss (``:333 causal_lm_loss``).

The port's ``ModelSpec`` carries what the ragged serving engine and the
training engine need. The sharding axes and pipeline parts of the JAX
package's spec arrive with multi-GPU training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class ModelSpec:
    """Everything the engines need to train or serve a model."""

    name: str
    config: Any
    # init_fn(generator, dtype, device) -> params dict (stacked [L, ...] layout)
    init_fn: Callable
    # loss_fn(params, batch, generator=None) -> 0-d fp32 loss (batch: dict of tensors)
    loss_fn: Callable | None = None
    # forward_fn(params, input_ids) -> [B, S, V] logits
    forward_fn: Callable | None = None
    # analytics
    num_params: int = 0
    flops_per_token: Callable[[int], float] | None = None
    # init_paged_cache_fn(num_blocks, block_size, dtype, device) -> cache;
    # ragged_forward_fn(params, tokens, slots, positions, block_tables, cache)
    #   -> (logits [T, V], cache); the cache is updated in place
    init_paged_cache_fn: Callable | None = None
    ragged_forward_fn: Callable | None = None
    # ragged_forward_fn accepts prefill_tiles=(n_dec, tile_slot, tile_pos0,
    # tile_valid, tile) for the tiled-prefill path
    supports_prefill_tiles: bool = False


def causal_lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    labels: torch.Tensor | None = None,
    ignore_index: int = -100,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Next-token cross entropy in fp32.

    With ``labels=None``, targets are ``input_ids`` shifted left (predict t+1
    from position t). Provided ``labels`` must already be aligned with logits.
    Positions equal to ``ignore_index`` are masked out.
    """
    if labels is None:
        logits = logits[:, :-1]
        targets = input_ids[:, 1:]
    else:
        targets = labels
    logits = logits.float()
    targets = targets.long()
    mask = (targets != ignore_index).float()
    safe_targets = torch.where(targets == ignore_index, 0, targets)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe_targets[..., None])[..., 0]
    nll = (logz - true_logit) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss > 0.0:
        loss = loss + z_loss * ((logz * mask) ** 2).sum() / denom
    return loss


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())
