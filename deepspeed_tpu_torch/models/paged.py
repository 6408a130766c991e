"""Paged KV-cache plumbing (counterpart of ``deepspeed_tpu/models/paged.py``):
the pool scatter and the decode / tiled-prefill attention split over the
block pool."""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.attention import paged_attention, ragged_prefill_attention
from deepspeed_tpu_torch.ops.cuda.paged_attention import DecodeWorkspace


def init_decode_workspace(num_heads: int, num_kv_heads: int, head_dim: int, device):
    """The decode kernel's scratch for a paged cache on ``device``, made once
    with the cache and kept with it; None on the CPU, whose plain version
    needs none."""
    if torch.device(device).type != "cuda":
        return None
    return DecodeWorkspace(device, num_heads, num_kv_heads, head_dim)


def write_kv_paged(kc, vc, kk, vv, slots, positions, block_tables):
    """Scatter each ragged token's new KV into (block, offset) of its
    sequence's pool blocks. ``kk``/``vv``: [T, Hkv, D].

    Writes ``kc``/``vc`` IN PLACE and returns them; the JAX version is
    functional and relies on buffer donation instead. Padding tokens (slot
    ``max_seqs``, position 0) all land in scratch block 0."""
    bs = kc.shape[1]
    positions = positions.long()
    blk = block_tables.long()[slots.long(), positions // bs]    # [T]
    off = positions % bs
    kc[blk, off] = kk.to(kc.dtype)
    vc[blk, off] = vv.to(vc.dtype)
    return kc, vc


def ragged_pool_attention(q, kc, vc, slots, positions, block_tables,
                          prefill_tiles=None, impl: str = "auto", workspace=None):
    """Attention over the blocked pool for a flat ragged token batch: the
    per-token paged kernel for the decode region, the tiled SplitFuse kernel
    for tile-aligned prefill chunks (``prefill_tiles`` =
    ``(n_dec, tile_slot, tile_pos0, tile_valid, tile)``). ``workspace``: the
    decode kernel's (``init_decode_workspace``)."""
    t_tokens = q.shape[0]
    if prefill_tiles is None:
        return paged_attention(q, kc, vc, slots, positions, block_tables,
                               impl=impl, workspace=workspace)
    n_dec, ts, tp, tv, ct = prefill_tiles
    parts = []
    if n_dec:
        parts.append(paged_attention(q[:n_dec], kc, vc, slots[:n_dec],
                                     positions[:n_dec], block_tables, impl=impl,
                                     workspace=workspace))
    if t_tokens > n_dec:
        parts.append(ragged_prefill_attention(q[n_dec:], kc, vc, ts, tp, tv,
                                              block_tables, ct, impl=impl))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
