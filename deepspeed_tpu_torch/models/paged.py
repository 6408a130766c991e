"""Paged KV-cache plumbing (counterpart of ``deepspeed_tpu/models/paged.py``):
the pool scatter, the decode / tiled-prefill attention split over the block
pool, and the verify-lane layout of self-speculative decoding."""

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


def speculative_lane_layout(cur_tok, draft, pos, live, cap, slots, scratch_slot: int):
    """Flatten a [T]-row decode batch plus per-row draft proposals into the
    flat verify batch one ragged forward consumes.

    Row ``r`` occupies lanes ``r (1+D) .. r (1+D) + D``: lane 0 feeds the
    row's current token at ``pos[r]`` (the plain decode step), lane ``1+i``
    feeds ``draft[r, i]`` at ``pos[r] + 1 + i``. One forward scores the
    committed step and every draft position, and since ``write_kv_paged``
    writes each lane's KV before attention runs, a later lane attends over
    the earlier lanes' keys of the same forward. Rejected-draft KV needs no
    rollback: positions are fed strictly in order, so a rejected cell is
    written again by a later forward before anything attends to it.

    Lanes of dead rows (``live`` False) and lanes at or past the row's
    covered capacity ``cap[r]`` (the first position without an allocated
    block) go to ``scratch_slot`` at position 0: their writes land in the
    scratch block and their picks are never surfaced. ``draft`` None means
    no draft (one lane a row). Returns flat ``(tokens, slots, positions,
    raw_positions)``, each [T (1+D)] int32; ``raw_positions`` keeps the
    positions before routing."""
    t = cur_tok.shape[0]
    d = 0 if draft is None else draft.shape[1]
    lanes = 1 + d
    lane_pos_raw = pos[:, None] + torch.arange(lanes, device=pos.device, dtype=pos.dtype)[None, :]
    lane_tok = cur_tok[:, None] if not d else torch.cat([cur_tok[:, None], draft], dim=1)
    ok = live[:, None] & (lane_pos_raw < cap[:, None])
    lane_slot = torch.where(ok, slots[:, None], scratch_slot)
    lane_pos = torch.where(ok, lane_pos_raw, 0)
    return (lane_tok.reshape(t * lanes).to(torch.int32),
            lane_slot.reshape(t * lanes).to(torch.int32),
            lane_pos.reshape(t * lanes).to(torch.int32),
            lane_pos_raw.reshape(t * lanes).to(torch.int32))
