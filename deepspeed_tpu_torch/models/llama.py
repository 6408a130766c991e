"""Llama-family causal LM (counterpart of ``deepspeed_tpu/models/llama.py``):
the training forward and loss, and the ragged inference path.

Parameters are a plain dict of tensors in the JAX package's stacked layout
(``embed [V, d]``, ``layers.* [L, ...]``, ``final_norm [d]``,
``lm_head [d, V]``), so ``models/convert.py`` moves weights between the two
packages with a copy. The decoder is a Python loop over the L layer views.

Activation checkpointing wraps each layer in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``; a remat
policy is a ``context_fn`` for it (``runtime/engine.py`` resolves the
config's policy names), and ``None`` saves nothing but the layer's input.
The JAX package's ``ShardCtx`` is not ported: on one device it is the
identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.api import ModelSpec, causal_lm_loss
from deepspeed_tpu_torch.models.paged import (init_decode_workspace, ragged_pool_attention,
                                              write_kv_paged)
from deepspeed_tpu_torch.ops.attention import apply_rope, attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                           num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
                           max_seq_len=8192)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> dict:
    """Random weights, each leaf drawn directly in ``dtype`` on ``device`` (no
    fp32 transient at full size); the JAX package's std and residual-out
    scaling. ``generator`` must live on ``device``."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    hq, hkv, nl = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    std = 0.02
    out_std = std / math.sqrt(2.0 * nl)

    def norm(*shape, s=std):
        w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return w.mul_(s)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {
        "embed": norm(cfg.vocab_size, d),
        "layers": {
            "attn_norm": ones(nl, d),
            "wq": norm(nl, d, hq * hd),
            "wk": norm(nl, d, hkv * hd),
            "wv": norm(nl, d, hkv * hd),
            "wo": norm(nl, hq * hd, d, s=out_std),
            "mlp_norm": ones(nl, d),
            "w_gate": norm(nl, d, f),
            "w_up": norm(nl, d, f),
            "w_down": norm(nl, f, d, s=out_std),
        },
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(d, cfg.vocab_size)
    return params


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def lm_head(cfg: LlamaConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ------------------------------------------------------------------ training
def _decoder_layer(cfg: LlamaConfig, attn_impl: str, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, hq, hd)
    kk = (h @ lp["wk"]).reshape(b, s, hkv, hd)
    vv = (h @ lp["wv"]).reshape(b, s, hkv, hd)
    q, kk = apply_rope(q, kk, positions, cfg.rope_theta)
    o = attention(q, kk, vv, causal=True, impl=attn_impl)
    x = x + o.reshape(b, s, hq * hd) @ lp["wo"]

    h = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def hidden_states(cfg: LlamaConfig, params: dict, input_ids: torch.Tensor,
                  attn_impl: str = "auto", remat_policy=None,
                  remat: bool = False) -> torch.Tensor:
    """[B, S] int tokens -> [B, S, D] final (post-norm) hidden states."""
    x = params["embed"][input_ids.long()]
    layer = partial(_decoder_layer, cfg, attn_impl)
    ckpt = {} if remat_policy is None else {"context_fn": remat_policy}
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in params["layers"].items()}
        if remat:
            x = checkpoint(layer, x, lp, use_reentrant=False, **ckpt)
        else:
            x = layer(x, lp)
    return rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)


def forward(cfg: LlamaConfig, params: dict, input_ids: torch.Tensor,
            attn_impl: str = "auto", remat_policy=None,
            remat: bool = False) -> torch.Tensor:
    """[B, S] int tokens -> [B, S, V] logits."""
    x = hidden_states(cfg, params, input_ids, attn_impl=attn_impl,
                      remat_policy=remat_policy, remat=remat)
    return x @ lm_head(cfg, params).to(x.dtype)


def loss_fn(cfg: LlamaConfig, params: dict, batch: dict, generator=None,
            attn_impl: str = "auto", remat_policy=None, remat: bool = False):
    """Next-token loss of ``batch["input_ids"]`` (``batch["labels"]`` when
    given). ``generator`` is the JAX loss's rng, which this model does not
    draw from."""
    del generator
    logits = forward(cfg, params, batch["input_ids"], attn_impl=attn_impl,
                     remat_policy=remat_policy, remat=remat)
    return causal_lm_loss(logits, batch["input_ids"], batch.get("labels"))


# ----------------------------------------------------------------- inference
def init_paged_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cpu") -> dict:
    """Blocked KV pool, stacked [L, num_blocks, block_size, Hkv, Dh]; block 0
    is the scratch block padding tokens write into. On a CUDA device the
    cache also holds the decode kernel's workspace (``"decode_workspace"``),
    which every layer's decode shares."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    workspace = init_decode_workspace(cfg.num_heads, cfg.num_kv_heads, cfg.hd, device)
    if workspace is not None:
        cache["decode_workspace"] = workspace
    return cache


def _ragged_layer(cfg: LlamaConfig, x, lp, kc, vc, positions, slots,
                  block_tables, prefill_tiles=None, attn_impl: str = "auto",
                  workspace=None):
    """One decoder layer over a flat ragged token batch ``x`` [T, D] that mixes
    prefill-chunk tokens and decode tokens of different sequences. New KV is
    scattered into the pool (in place) *before* attention, so intra-chunk
    causal attention falls out of the position mask. ``prefill_tiles``: see
    ``models/paged.ragged_pool_attention``."""
    t_tokens, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = (h @ lp["wq"]).reshape(t_tokens, hq, hd)
    kk = (h @ lp["wk"]).reshape(t_tokens, hkv, hd)
    vv = (h @ lp["wv"]).reshape(t_tokens, hkv, hd)
    q, kk = apply_rope(q[None], kk[None], positions[None], cfg.rope_theta)
    q, kk = q[0], kk[0]

    write_kv_paged(kc, vc, kk, vv, slots, positions, block_tables)
    o = ragged_pool_attention(q, kc, vc, slots, positions, block_tables,
                              prefill_tiles, impl=attn_impl, workspace=workspace).to(x.dtype)
    x = x + o.reshape(t_tokens, hq * hd) @ lp["wo"]

    h = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


@torch.no_grad()
def ragged_forward(cfg: LlamaConfig, params, tokens, slots, positions,
                   block_tables, cache, prefill_tiles=None, attn_impl: str = "auto"):
    """Flat ragged step: ``[T]`` mixed tokens -> (``[T, V]`` logits, cache).

    Each token carries (slot, absolute position); ``block_tables``
    [max_seqs+1, max_blocks] maps slots to KV pool blocks (row ``max_seqs``
    is the all-scratch padding row). The cache is updated in place and
    returned. ``prefill_tiles``: tiled-prefill layout (``_ragged_layer``).
    ``attn_impl``: ``"auto"`` (kernel on CUDA tensors), or ``"plain"`` to run
    the attention oracle instead (tests and ``chip_smoke.py`` only).
    """
    x = params["embed"][tokens.long()].to(cache["k"].dtype)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x = _ragged_layer(cfg, x, lp, cache["k"][i], cache["v"][i], positions,
                          slots, block_tables, prefill_tiles, attn_impl,
                          cache.get("decode_workspace"))
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = x @ lm_head(cfg, params).to(x.dtype)
    return logits, cache


def num_params(cfg: LlamaConfig) -> int:
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    per_layer = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2) + 3 * d * f + 2 * d
    total = cfg.vocab_size * d + cfg.num_layers * per_layer + d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    return total


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token (PaLM convention): 6*N matmul + 6*L*D*S causal
    attention (12*L*D*S non-causal, halved)."""
    return 6.0 * num_params(cfg) + 12.0 * cfg.num_layers * cfg.hidden_size * seq_len / 2.0


def build(cfg: LlamaConfig, remat: bool = False, remat_policy=None) -> ModelSpec:
    """The model's spec; ``remat`` and ``remat_policy`` (a ``context_fn`` or
    None) select activation checkpointing of each decoder layer."""
    ckpt = dict(remat=remat, remat_policy=remat_policy)
    return ModelSpec(
        name="llama",
        config=cfg,
        init_fn=partial(init_params, cfg),
        loss_fn=partial(loss_fn, cfg, **ckpt),
        forward_fn=partial(forward, cfg, **ckpt),
        num_params=num_params(cfg),
        flops_per_token=partial(flops_per_token, cfg),
        init_paged_cache_fn=partial(init_paged_cache, cfg),
        ragged_forward_fn=partial(ragged_forward, cfg),
        supports_prefill_tiles=True,
    )
