"""Draft proposal and acceptance for self-speculative decoding (counterpart
of the speculative part of ``deepspeed_tpu/inference/sampling.py``).

Both functions are plain tensor code on int32 tensors with static ``ngram``
and ``depth``, so the ragged engine's scheduler program runs them on the
device inside its loop, reading the token history the loop itself appends
to, and a CUDA graph can capture them (no host read, no data-dependent
shape).

Verification is exact-match against the target model's own picks, so the
surfaced stream equals plain decoding. The port decodes greedily only:
seeded sampling (``keys_for_positions``, ``sample_tokens``, threefry) is not
ported yet (``ROADMAP.md`` queue 1, item 7), and with it the scheduler
program's sampled, top-k and top-p branches; ``put(temperature > 0)``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch


def propose_ngram_drafts(hist: torch.Tensor, pos: torch.Tensor, ngram: int, depth: int):
    """Prompt-lookup draft source (self-speculation without a draft model):
    for each row, match the ``ngram``-token suffix ending at ``pos`` against
    every earlier window of that row's token history and propose the
    ``depth`` tokens that followed the MOST RECENT match.

    ``hist`` [T, S] int32: ``hist[r, p]`` is the token at context position
    ``p`` (positions past the row's frontier hold stale values, which is
    safe because proposals are always verified). ``pos`` [T] int32: index
    of the newest valid token per row. Returns ``(draft [T, depth] int32,
    matched [T] bool)``; unmatched rows draft zeros."""
    t, s = hist.shape
    idxs = torch.arange(s, device=hist.device)[None, :]            # candidate ends j
    pos_l = pos.long()[:, None]
    match = torch.ones((t, s), dtype=torch.bool, device=hist.device)
    for i in range(ngram):
        sfx_i = torch.gather(hist, 1, torch.clamp(pos_l - i, 0, s - 1))             # [T, 1]
        cand = torch.gather(hist, 1, torch.clamp(idxs - i, 0, s - 1).expand(t, s))  # [T, S]
        match &= cand == sfx_i
    valid = (idxs >= ngram - 1) & (idxs < pos_l) & (pos_l >= ngram - 1)
    jstar = torch.where(match & valid, idxs, -1).amax(dim=1)        # [T]
    matched = jstar >= 0
    lanes = torch.arange(depth, device=hist.device)[None, :]
    gather = torch.clamp(jstar[:, None] + 1 + lanes, 0, s - 1)
    draft = torch.gather(hist, 1, gather)
    return torch.where(matched[:, None], draft, 0).to(torch.int32), matched


def accept_drafts(draft: torch.Tensor, picked: torch.Tensor, budget: torch.Tensor,
                  eos: torch.Tensor):
    """Acceptance prefix of exact-match speculative verification.

    ``picked`` [T, 1+D]: the target model's picks at the verify lanes (lane
    i is the pick for generated index g + i); ``draft`` [T, D]: the proposed
    continuation (draft lane i was fed at verify lane i + 1). A draft token
    is accepted while it equals the target's own pick for that index; the
    first mismatching lane contributes the target's pick as the bonus
    token. ``budget`` [T] caps the surfaced tokens; ``eos`` [T] (-1: none)
    truncates at the first EOS, inclusive. Returns ``(n_emit [T],
    n_accepted [T])``: surface ``picked[r, :n_emit[r]]``; ``n_accepted``
    counts the surfaced tokens that came from the draft (the bonus
    excluded)."""
    t, lanes = picked.shape
    d = lanes - 1
    lane_i = torch.arange(lanes, device=picked.device)[None, :]
    # leading matches: the first mismatching draft lane, or d
    a = torch.where(draft != picked[:, :d], lane_i[:, :d], d).amin(dim=1) if d else \
        torch.zeros(t, dtype=torch.int64, device=picked.device)
    n_emit = torch.minimum(a + 1, torch.clamp(budget.long(), min=0))
    is_eos = (picked == eos[:, None]) & (eos >= 0)[:, None]
    eos_at = torch.where(is_eos & (lane_i < n_emit[:, None]), lane_i, lanes).amin(dim=1)
    n_emit = torch.where(eos_at < n_emit, eos_at + 1, n_emit)
    return n_emit.to(torch.int32), torch.minimum(n_emit, a).to(torch.int32)
