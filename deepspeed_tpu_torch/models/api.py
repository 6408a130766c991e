"""Model contract (counterpart of ``deepspeed_tpu/models/api.py:282 ModelSpec``)
and the causal-LM loss (``:333 causal_lm_loss``).

The port's ``ModelSpec`` carries what the dense and ragged serving engines
and the training engine need, with the params' logical axes that the ZeRO
planner reads (``parallel/partition.py``). The pipeline parts of the JAX
package's spec arrive with item 12.

``ShardCtx`` carries into model code the one hook of the JAX package's
(``deepspeed_tpu/models/api.py:45``) the port needs: the engine's ZeRO-3
gather, installed on the spec's context as the JAX engine installs its qwZ
and param-stream hooks. Model code calls
``ctx.gather(key, w)`` where it uses a parameter (a layer's weights inside
the checkpointed layer function, so the recompute gathers again); with no
hook installed it is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class ShardCtx:
    """Per-model hooks the engine installs. ``param_gather(key, w,
    stacked)``: the full compute-dtype weight for the leaf ``key``
    (``keystr`` of its path) from what the engine passed in; ``stacked``
    says ``w`` is one layer's slice of a ``[L, ...]`` leaf."""

    param_gather: Any = None

    def gather(self, key: str, w, stacked: bool = False):
        return w if self.param_gather is None else self.param_gather(key, w, stacked)


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
    # dense inference: init_cache_fn(batch, max_len, dtype, device) -> cache;
    # decode_fn(params, tokens, cache, start_pos) -> (logits [B, T, V], cache);
    # the cache is updated in place
    init_cache_fn: Callable | None = None
    decode_fn: Callable | None = None
    # init_paged_cache_fn(num_blocks, block_size, dtype, device) -> cache;
    # ragged_forward_fn(params, tokens, slots, positions, block_tables, cache)
    #   -> (logits [T, V], cache); the cache is updated in place
    init_paged_cache_fn: Callable | None = None
    ragged_forward_fn: Callable | None = None
    # ragged_forward_fn accepts prefill_tiles=(n_dec, tile_slot, tile_pos0,
    # tile_valid, tile) for the tiled-prefill path
    supports_prefill_tiles: bool = False
    # parameter names weight-only quantization keeps dense (the embedding
    # gather wants a plain tensor)
    woq_skip: tuple = ("embed",)
    # tree congruent to the params, each leaf a tuple of logical axis names
    # (``"layers"``, ``"embed"``, ``"heads"``, ...), for the ZeRO planner
    param_logical_axes: Any = None
    # the context the model's functions read their hooks from
    shard_ctx: ShardCtx | None = None


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
