"""Token sampling and self-speculative drafting (counterpart of
``deepspeed_tpu/inference/sampling.py``).

Sampling: temperature, top-k, top-p and the repetition penalty, with the
reference's semantics and its ``_NEG`` fill, each control a per-row tensor
(scalars broadcast), so one program serves a batch that mixes greedy and
sampled rows. Draws come from ``utils/prng.py``, the port's bit-exact copy
of threefry and ``jax.random.categorical``, so a seeded request picks the
reference's tokens:

- ``temperature`` <= 0 is greedy (argmax); otherwise logits /= temperature;
- ``top_k`` 0 keeps every logit, otherwise the k highest;
- ``top_p`` >= 1 keeps every logit, otherwise the smallest prefix of the
  descending distribution whose mass reaches ``top_p`` (the most likely
  token always stays);
- ``repetition_penalty`` 1.0 is off; otherwise logits of tokens seen in the
  row's context are divided by it when positive and multiplied when
  negative (the CTRL rule).

Drafting and acceptance: prompt lookup over each row's token history and
exact-match verification against the target model's own picks, so the
surfaced stream equals plain decoding, greedy and seeded (a seeded pick is
a function of the request's seed and the token's index only).

Everything here is plain tensor code with static shapes and no host read,
so the engines' programs run it on the device and a CUDA graph captures it.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.utils import prng

_NEG = -1e30


def apply_repetition_penalty(logits, seen_mask, penalty):
    """CTRL-rule repetition penalty: ``logits`` [T, V] fp32, ``seen_mask``
    [T, V] (nonzero: the token occurred in the row's context), ``penalty``
    [T] fp32 (1.0: off)."""
    pen = penalty[:, None]
    seen = seen_mask.bool()
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen & (pen != 1.0), penalized, logits)


def _mask_top_k(logits, top_k):
    """Keep each row's ``top_k`` highest logits (0: all), by the k-th order
    statistic; ``top_k`` [T] int."""
    v = logits.shape[-1]
    k = torch.where(top_k <= 0, v, torch.clamp(top_k, max=v)).long()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    return torch.where(logits >= kth, logits, _NEG)


def _softmax(x):
    """``jax.nn.softmax`` along the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _log_softmax(x):
    """``jax.nn.log_softmax`` along the last axis, in its order of operations."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _mask_top_p(logits, top_p):
    """Nucleus filtering, ``top_p`` [T] fp32 (>= 1: off): a position of the
    descending order survives while the mass before it is below ``top_p``."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = _softmax(sorted_desc)
    prev = torch.cumsum(probs, dim=-1) - probs
    n_keep = (prev < top_p[:, None]).sum(dim=-1)  # >= 1
    thr = torch.gather(sorted_desc, -1, (n_keep - 1)[:, None])
    disabled = (top_p >= 1.0)[:, None]
    return torch.where(disabled | (logits >= thr), logits, _NEG)


def _as_row(x, t: int, dtype, device):
    """A control as a [t] row: a tensor broadcast, a scalar filled on the
    device (no host copy, so a graph captures it)."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(dtype).expand(t)
    return torch.full((t,), x, dtype=dtype, device=device)


def sample_tokens(logits, rng, temperature, top_k=None, top_p=None,
                  repetition_penalty=None, seen_mask=None):
    """Pick the next token of each row of ``logits`` [T, V] (any float
    dtype). Controls are per-row tensors or scalars; ``None`` leaves a
    filter out. ``rng`` is one key [2] (one draw over the whole batch) or
    per-row keys [T, 2] (each row's draw a function of its key alone).
    Returns (tokens [T] int32, logprobs [T] fp32): the logprob of the picked
    token under the final (tempered, filtered) distribution; greedy rows
    report the untempered log-softmax."""
    logits = logits.float()
    t, dev = logits.shape[0], logits.device
    temperature = _as_row(temperature, t, torch.float32, dev)
    top_k = _as_row(top_k, t, torch.int32, dev)
    top_p = _as_row(top_p, t, torch.float32, dev)
    repetition_penalty = _as_row(repetition_penalty, t, torch.float32, dev)

    if repetition_penalty is not None and seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    greedy = temperature <= 0.0
    filt = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k is not None:
        filt = _mask_top_k(filt, top_k)
    if top_p is not None:
        filt = _mask_top_p(filt, top_p)
    sampled = prng.categorical(rng, filt)
    greedy_tok = torch.argmax(logits, dim=-1)
    toks = torch.where(greedy, greedy_tok, sampled)
    lp = torch.where(greedy,
                     torch.gather(_log_softmax(logits), -1, greedy_tok[:, None])[:, 0],
                     torch.gather(_log_softmax(filt), -1, toks[:, None])[:, 0])
    return toks.to(torch.int32), lp


def per_request_keys(root, seeds, gen_idx):
    """Per-row keys [T, 2]: ``fold_in(fold_in(root, seed), g)``. The draw for
    token ``g`` of a request depends on (root, seed, g) alone, never on the
    batch, the dispatch mode or the engine's history."""
    return prng.fold_in(prng.fold_in(root, seeds), gen_idx)


def keys_for_positions(root, seeds, positions, prompt_lens):
    """``per_request_keys`` from the device-resident slot rows: the token
    made by feeding position ``p`` is the request's generated token
    ``p - prompt_len + 1``."""
    return per_request_keys(root, seeds, positions - prompt_lens + 1)


def update_seen(seen_mask, tokens):
    """Mark freshly picked ``tokens`` [T] in the occurrence mask [T, V], in
    place; returns the mask."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    # the value a tensor on the device: a Python True would be copied from
    # the host, which a CUDA graph cannot capture
    seen_mask.index_put_((rows, tokens.long()), torch.ones_like(tokens, dtype=torch.bool))
    return seen_mask


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
