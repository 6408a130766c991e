"""Llama-family causal LM (counterpart of ``deepspeed_tpu/models/llama.py``):
the training forward and loss, the dense-cache inference path and the
ragged one.

Parameters are a plain dict of tensors in the JAX package's stacked layout
(``embed [V, d]``, ``layers.* [L, ...]``, ``final_norm [d]``,
``lm_head [d, V]``), so ``models/convert.py`` moves weights between the two
packages with a copy. The decoder is a Python loop over the L layer views.

Activation checkpointing wraps each layer in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``; a remat
policy is a ``context_fn`` for it (``runtime/engine.py`` resolves the
config's policy names), and ``None`` saves nothing but the layer's input.
The training functions take a ``ShardCtx`` (``models/api.py``): each layer
passes its weights through ``ctx.gather`` first thing inside the
checkpointed layer function (the ZeRO-3 gather, and its recompute in the
backward), and the embedding, final norm and head where they are used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.api import ModelSpec, ShardCtx, causal_lm_loss
from deepspeed_tpu_torch.models.paged import (append_kv_and_attend, init_decode_workspace,
                                              ragged_pool_attention, write_kv_paged)
from deepspeed_tpu_torch.ops.attention import apply_rope, attention
from deepspeed_tpu_torch.ops.quantizer import dequantize_layer, maybe_dequantize


# logical axes of each parameter (``deepspeed_tpu/models/llama.py:89``)
PARAM_LOGICAL_AXES = {
    "embed": ("vocab", "embed"),
    "layers": {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "ffn"),
        "w_up": ("layers", "embed", "ffn"),
        "w_down": ("layers", "ffn", "embed"),
    },
    "final_norm": ("embed",),
    "lm_head": ("embed", "vocab"),
}

_NO_CTX = ShardCtx()


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


def lm_head(cfg: LlamaConfig, params: dict, dtype: torch.dtype,
            ctx: ShardCtx = _NO_CTX) -> torch.Tensor:
    """The output projection in ``dtype``; a weight-only quantized head
    dequantizes straight into it (the reference dequantizes to fp32 and
    casts: one rounding of the same fp32 product either way)."""
    if cfg.tie_embeddings:
        return ctx.gather("['embed']", params["embed"]).T.to(dtype)
    return maybe_dequantize(ctx.gather("['lm_head']", params["lm_head"]), dtype).to(dtype)


# ------------------------------------------------------------------ training
def _decoder_layer(cfg: LlamaConfig, attn_impl: str, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor | None = None,
                   ctx: ShardCtx = _NO_CTX) -> torch.Tensor:
    # the reference's ShardCtx.layer_weights: the ZeRO-3 gather of this
    # layer's weights, then weight-only dequantization (the dense engine's
    # forward() on quantized weights; training's dicts hold none)
    if ctx.param_gather is not None:
        lp = {k: ctx.gather(f"['layers'][{k!r}]", w, stacked=True) for k, w in lp.items()}
    lp = dequantize_layer(lp, x.dtype)
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
                  remat: bool = False, ctx: ShardCtx = _NO_CTX) -> torch.Tensor:
    """[B, S] int tokens -> [B, S, D] final (post-norm) hidden states."""
    x = ctx.gather("['embed']", params["embed"])[input_ids.long()]
    layer = partial(_decoder_layer, cfg, attn_impl, ctx=ctx)
    ckpt = {} if remat_policy is None else {"context_fn": remat_policy}
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in params["layers"].items()}
        if remat:
            x = checkpoint(layer, x, lp, use_reentrant=False, **ckpt)
        else:
            x = layer(x, lp)
    return rmsnorm(x, ctx.gather("['final_norm']", params["final_norm"]), cfg.rms_norm_eps)


def forward(cfg: LlamaConfig, params: dict, input_ids: torch.Tensor,
            attn_impl: str = "auto", remat_policy=None,
            remat: bool = False, ctx: ShardCtx = _NO_CTX) -> torch.Tensor:
    """[B, S] int tokens -> [B, S, V] logits."""
    x = hidden_states(cfg, params, input_ids, attn_impl=attn_impl,
                      remat_policy=remat_policy, remat=remat, ctx=ctx)
    return x @ lm_head(cfg, params, x.dtype, ctx)


def loss_fn(cfg: LlamaConfig, params: dict, batch: dict, generator=None,
            attn_impl: str = "auto", remat_policy=None, remat: bool = False,
            ctx: ShardCtx = _NO_CTX):
    """Next-token loss of ``batch["input_ids"]`` (``batch["labels"]`` when
    given). ``generator`` is the JAX loss's rng, which this model does not
    draw from."""
    del generator
    logits = forward(cfg, params, batch["input_ids"], attn_impl=attn_impl,
                     remat_policy=remat_policy, remat=remat, ctx=ctx)
    return causal_lm_loss(logits, batch["input_ids"], batch.get("labels"))


# ----------------------------------------------------------------- inference
def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Dense KV cache of the dense engine, stacked [L, B, max_len, Hkv, Dh]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_layer(cfg: LlamaConfig, x, lp, k_cache, v_cache, start_pos, max_len: int):
    """One decoder layer of a dense prefill or decode step: the new KV is
    appended at ``start_pos`` (in place) and attention runs over the cache
    under the absolute-position mask (``models/paged.append_kv_and_attend``).
    Weight-only quantized weights dequantize here, one layer at a time."""
    lp = dequantize_layer(lp, x.dtype)
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = (h @ lp["wq"]).reshape(b, t, hq, hd)
    kk = (h @ lp["wk"]).reshape(b, t, hkv, hd)
    vv = (h @ lp["wv"]).reshape(b, t, hkv, hd)
    positions = (start_pos + torch.arange(t, device=x.device))[None, :].expand(b, t)
    q, kk = apply_rope(q, kk, positions, cfg.rope_theta)

    o = append_kv_and_attend(q, kk, vv, k_cache, v_cache, start_pos, max_len)
    x = x + o.reshape(b, t, hq * hd) @ lp["wo"]

    h = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


@torch.no_grad()
def decode_forward(cfg: LlamaConfig, params, tokens, cache, start_pos):
    """[B, T] new tokens at positions ``start_pos ..`` over the dense cache
    -> ([B, T, V] logits, cache): a prefill (T = prompt length, start 0) or
    a decode step (T = 1). The cache is updated in place and returned;
    ``start_pos`` is an int or a 0-d device tensor."""
    max_len = cache["k"].shape[2]
    x = params["embed"][tokens.long()].to(cache["k"].dtype)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x = _cached_layer(cfg, x, lp, cache["k"][i], cache["v"][i], start_pos, max_len)
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    return x @ lm_head(cfg, params, x.dtype), cache


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
    ``models/paged.ragged_pool_attention``. Weight-only quantized weights
    dequantize here, one layer at a time."""
    lp = dequantize_layer(lp, x.dtype)
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
    logits = x @ lm_head(cfg, params, x.dtype)
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
    None) select activation checkpointing of each decoder layer. Each call
    makes the spec its own ``ShardCtx``."""
    ctx = ShardCtx()
    ckpt = dict(remat=remat, remat_policy=remat_policy, ctx=ctx)
    axes = dict(PARAM_LOGICAL_AXES)
    if cfg.tie_embeddings:
        axes = {k: v for k, v in axes.items() if k != "lm_head"}
    return ModelSpec(
        name="llama",
        config=cfg,
        init_fn=partial(init_params, cfg),
        loss_fn=partial(loss_fn, cfg, **ckpt),
        forward_fn=partial(forward, cfg, **ckpt),
        num_params=num_params(cfg),
        flops_per_token=partial(flops_per_token, cfg),
        init_cache_fn=partial(init_cache, cfg),
        decode_fn=partial(decode_forward, cfg),
        init_paged_cache_fn=partial(init_paged_cache, cfg),
        ragged_forward_fn=partial(ragged_forward, cfg),
        supports_prefill_tiles=True,
        param_logical_axes=axes,
        shard_ctx=ctx,
    )
