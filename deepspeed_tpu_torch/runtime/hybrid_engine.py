"""Hybrid engine: train and generate on the same weights, the RLHF loop
(counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``).

The training engine's masters are the generation weights; what the
reference's container machinery buys is kept:

- *one cast a training step*: the fp32 masters are cast to the inference
  dtype once a step (``eval_params``), into buffers kept from step to step,
  and every ``generate`` of that step reads them. Because the buffers stay,
  the programs ``generate`` captures on the card (the dense engine's
  ``_Generation``, through ``inference/cuda_graphs.ProgramCache``) replay
  on the new weights after the next step's cast.
- *rollout batching*: ``generate_rollouts`` runs a prompt set through
  exact-length groups of ``rollout_batch_size`` and returns tokens and each
  token's logprob.
- *a cache kept across calls*: ``prefill`` / ``decode_more`` carry a
  ``GenState``, so a multi-turn rollout never re-prefills.

Decoding runs ``models/llama.py decode_forward`` as the dense engine does.
At ZeRO stage 3 the cast gathers each master's shards (every rank calls
``eval_params`` together).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.topology import AXIS_FSDP
from deepspeed_tpu_torch.inference.cuda_graphs import ProgramCache
from deepspeed_tpu_torch.inference.engine import _Generation
from deepspeed_tpu_torch.inference.sampling import sample_tokens
from deepspeed_tpu_torch.runtime.engine import Engine, _map_tree
from deepspeed_tpu_torch.utils import prng


@dataclass
class GenState:
    """Generation state carried across ``decode_more`` calls."""

    cache: Any            # the dense KV cache [L, B, max_len, Hkv, Dh] (k, v)
    last_logits: Any      # [B, V] fp32 logits of the last processed position
    pos: int              # next write position
    tokens: np.ndarray    # [B, pos] everything processed so far (host)
    max_len: int


class _Rollout(_Generation):
    """The dense engine's generation with each picked token's logprob kept
    (``sample_tokens``' second output; a greedy row reports the untempered
    log-softmax, and its token is the argmax, as the dense engine's)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.lps = torch.zeros(self.out.shape, dtype=torch.float32, device=self.out.device)

    def _pick(self, key) -> torch.Tensor:
        tok, lp = sample_tokens(
            self.last, key, self.temperature if self.sample else 0.0,
            top_k=self.top_k if self.has_tk else None,
            top_p=self.top_p if self.has_tp else None,
            repetition_penalty=self.penalty if self.use_penalty else None,
            seen_mask=self.seen if self.use_penalty else None)
        self.lps.index_copy_(1, self.i.reshape(1), lp[:, None])
        return tok


def _random_seed(key: torch.Tensor) -> int:
    """``jax.random.randint(key, (), 0, 2**31 - 1)``: at this span the
    reference's multiplier is 0 and the draw is the second half-key's bits
    modulo the span."""
    bits = prng.random_bits(prng.fold_in(key, 1), (1,))[0]  # shape (): counter 0 too
    return int(bits.item()) % (2 ** 31 - 1)


class HybridEngine(Engine):
    """``Engine`` plus generation on its current weights."""

    def __init__(self, *args, inference_dtype=torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        if self.model_spec.decode_fn is None:
            raise ValueError(f"model {self.model_spec.name} has no decode support")
        self.inference_dtype = inference_dtype
        self.programs = ProgramCache(self.device)
        self._gen_cache: dict = {}
        self._eval_params = None
        self._eval_step = -1
        self.eval_casts = 0  # casts done, for the one-a-step check

    # ------------------------------------------------------------- eval cast
    def invalidate_eval_cache(self) -> None:
        """Make the next ``eval_params`` cast again (anything that replaces
        the masters outside a training step calls this)."""
        self._eval_step = -1

    def load_checkpoint(self, *args, **kwargs):
        # the restored global_steps can equal the cast's step stamp, which
        # would serve rollouts from the weights before the load
        out = super().load_checkpoint(*args, **kwargs)
        self.invalidate_eval_cache()
        return out

    @torch.no_grad()
    def _full_master(self, key: str, p: torch.Tensor) -> torch.Tensor:
        lp = self.plan.leaves[key]
        if lp.params_sharded:
            return comm.all_gather(p.detach(), AXIS_FSDP, gather_dim=lp.dim)
        return p.detach()

    @property
    def eval_params(self) -> dict:
        """The current weights in the inference dtype, cast once a training
        step into the same buffers, and shared by every ``generate`` until
        the next step."""
        if self._eval_step != self.global_steps:
            with torch.no_grad():
                if self._eval_params is None:
                    dtype = self.inference_dtype
                    self._eval_params = _map_tree(self.params, lambda k, p: (
                        self._full_master(k, p).to(dtype, copy=True)))
                    self._eval_leaves = dict(ser.flatten_with_keys(self._eval_params))
                else:  # into the same buffers: captured programs read them
                    for key, p in zip(self._keys, self._leaves):
                        self._eval_leaves[key].copy_(self._full_master(key, p))
            self._eval_step = self.global_steps
            self.eval_casts += 1
        return self._eval_params

    # -------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 64, temperature: float = 0.0,
                 seed: int | None = None, return_logprobs: bool = False, top_k: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0):
        """Rollout generation on the current training weights: [B, T] ->
        [B, T + max_new_tokens] (and [B, max_new_tokens] logprobs). With no
        ``seed`` the key comes from the engine's stream, as in the reference."""
        input_ids = np.asarray(input_ids)
        b, t = input_ids.shape
        sample = temperature > 0.0
        use_penalty = repetition_penalty != 1.0
        has_tk, has_tp = top_k > 0, top_p < 1.0
        key = (b, t, max_new_tokens, sample, use_penalty, has_tk, has_tp)
        params = self.eval_params
        gen = self._gen_cache.get(key)
        if gen is None:
            gen = self._gen_cache[key] = _Rollout(self.model_spec, params,
                                                  self.inference_dtype, self.device, *key)
        rng = prng.prng_key(seed) if seed is not None else self._next_rng()
        gen.tokens.copy_(torch.from_numpy(input_ids.astype(np.int32)))
        gen.rng.copy_(rng)
        gen.temperature.fill_(max(temperature, 1e-6))
        gen.top_k.fill_(top_k)
        gen.top_p.fill_(top_p)
        gen.penalty.fill_(repetition_penalty)
        self.programs.run(("prefill", *key), gen.prefill)
        for _ in range(max_new_tokens):
            self.programs.run(("decode", *key), gen.step)
        full = np.concatenate([input_ids, gen.out.cpu().numpy()], axis=1)
        if return_logprobs:
            return full, gen.lps.cpu().numpy()
        return full

    def generate_rollouts(self, prompts, rollout_batch_size: int = 8,
                          max_new_tokens: int = 64, temperature: float = 1.0,
                          seed: int | None = None, pad_token_id: int = 0, top_k: int = 0,
                          top_p: float = 1.0, repetition_penalty: float = 1.0) -> list:
        """Batched rollouts over a prompt set, grouped by exact length (a pad
        between prompt and continuation would poison the logprobs), each
        group in batches of ``rollout_batch_size``. Returns, in input order,
        ``{"prompt", "tokens", "logprobs", "full"}``."""
        del pad_token_id  # exact-length grouping needs none
        prompts = [np.asarray(p).reshape(-1).astype(np.int32) for p in prompts]
        out: list = [None] * len(prompts)
        base_seed = seed if seed is not None else _random_seed(self._next_rng())
        by_len: dict = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        call = 0
        for length in sorted(by_len):
            idxs = by_len[length]
            for start in range(0, len(idxs), rollout_batch_size):
                idx = idxs[start:start + rollout_batch_size]
                full, lps = self.generate(
                    np.stack([prompts[i] for i in idx]), max_new_tokens=max_new_tokens,
                    temperature=temperature, seed=base_seed + call, return_logprobs=True,
                    top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty)
                call += 1
                for j, i in enumerate(idx):
                    out[i] = {"prompt": prompts[i], "tokens": full[j, length:],
                              "logprobs": lps[j], "full": full[j]}
        return out

    # ---------------------------------------------------- a cache across calls
    @torch.no_grad()
    def prefill(self, input_ids, max_len: int) -> GenState:
        """A prompt batch into a persistent cache; follow with ``decode_more``."""
        input_ids = np.asarray(input_ids)
        b, t = input_ids.shape
        if t > max_len:
            raise ValueError(f"prompt {t} exceeds max_len {max_len}")
        cache = self.model_spec.init_cache_fn(b, max_len, self.inference_dtype, self.device)
        tokens = torch.from_numpy(input_ids.astype(np.int32)).to(self.device)
        logits, cache = self.model_spec.decode_fn(self.eval_params, tokens, cache, 0)
        return GenState(cache=cache, last_logits=logits[:, t - 1].float(), pos=t,
                        tokens=input_ids.copy(), max_len=max_len)

    @torch.no_grad()
    def decode_more(self, state: GenState, n_tokens: int, temperature: float = 0.0,
                    seed: int | None = None, top_k: int = 0, top_p: float = 1.0) -> GenState:
        """Extend a ``GenState`` by ``n_tokens`` greedy or sampled tokens; the
        cache is updated in place (no repetition penalty: its occurrence mask
        would have to live in the state)."""
        if state.pos + n_tokens > state.max_len:
            raise ValueError(
                f"decode_more past max_len: {state.pos}+{n_tokens} > {state.max_len}")
        rng = prng.prng_key(seed, self.device) if seed is not None else \
            self._next_rng().to(self.device)
        params, last, cache = self.eval_params, state.last_logits, state.cache
        toks = []
        for i in range(n_tokens):
            if temperature > 0.0:
                tok, _ = sample_tokens(last, prng.fold_in(rng, i), temperature,
                                       top_k=top_k if top_k > 0 else None,
                                       top_p=top_p if top_p < 1.0 else None)
            else:
                tok = torch.argmax(last, dim=-1).to(torch.int32)
            logits, cache = self.model_spec.decode_fn(params, tok[:, None], cache,
                                                      state.pos + i)
            last = logits[:, 0].float()
            toks.append(tok)
        new = torch.stack(toks, dim=1).cpu().numpy() if toks else \
            np.zeros((state.tokens.shape[0], 0), np.int32)
        return GenState(cache=cache, last_logits=last, pos=state.pos + n_tokens,
                        tokens=np.concatenate([state.tokens, new], axis=1),
                        max_len=state.max_len)
