"""Attention ops with implementation dispatch (counterpart of
``deepspeed_tpu/ops/attention.py``).

``impl="auto"`` calls the kernel's wrapper, which launches the hand-written
CUDA kernel for a CUDA tensor and computes the plain PyTorch version for a
CPU tensor. There is no fall back, no context-length crossover and no
switch: ``impl="plain"`` exists so tests and ``chip_smoke.py`` can run the
oracle on the card; the engines never pass it. Training attention
(``attention``) with ``"auto"`` and no bias is the flash-attention autograd
function; with a bias, or with ``"plain"``, it is ``eager_attention``.

A quantized paged pool (``inference/kvquant.QuantizedKV``) takes
``quantized_decode_attention`` / ``quantized_prefill_attention`` whatever
``impl`` says: plain versions that dequantize in the gather, as the
reference sends such a pool to XLA. The path is chosen by the pool's type,
never by a kernel's failure.

Layouts: q [B, S, Hq, D], k/v [B, S, Hkv, D] (GQA: Hq % Hkv == 0); the paged
pool is [NB, BS, Hkv, D].
"""

from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as _flash
from deepspeed_tpu_torch.ops.cuda import paged_attention as _paged


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _pick(impl: str, wrapper, plain):
    """The kernel's wrapper for ``"auto"`` (it decides by device), the plain
    version for ``"plain"``."""
    if impl == "auto":
        return wrapper
    if impl == "plain":
        return plain
    raise ValueError(f"unknown attention impl {impl!r}; want 'auto' or 'plain'")


def eager_attention(q, k, v, causal: bool = True, bias=None, scale: float | None = None):
    """The eager oracle (counterpart of ``deepspeed_tpu/ops/attention.py:36
    xla_attention``): fp32 scores, an optional additive bias, the causal
    mask aligned at the end of the keys (queries are the last Sq positions of
    Skv), softmax in fp32, and the weights cast to v's dtype before P @ V."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def attention(q, k, v, causal: bool = True, bias=None, scale: float | None = None,
              impl: str = "auto"):
    """Dispatching training attention (counterpart of
    ``deepspeed_tpu/ops/attention.py:68 attention``): ``"auto"`` without a
    bias is the flash-attention autograd function (kernels on CUDA tensors,
    their plain versions on CPU tensors); with a bias it is
    ``eager_attention``, as the reference routes it; ``"plain"`` is
    ``eager_attention``."""
    if _pick(impl, True, False) and bias is None:
        return _flash.flash_attention(q, k, v, causal, scale)
    return eager_attention(q, k, v, causal=causal, bias=bias, scale=scale)


def paged_attention(q, k_pool, v_pool, slots, positions, block_tables,
                    scale: float | None = None, impl: str = "auto", workspace=None):
    """Ragged paged-KV attention: [T, Hq, D] tokens over the blocked pool,
    token t attending positions 0..positions[t] of table row slots[t].
    ``workspace``: the kernel's ``DecodeWorkspace`` (the plain version needs
    none)."""
    if getattr(k_pool, "is_quantized_kv", False):
        return _paged.quantized_decode_attention(q, k_pool, v_pool, slots, positions,
                                                 block_tables, scale=scale)
    if _pick(impl, True, False):
        return _paged.paged_decode_attention(q, k_pool, v_pool, slots, positions,
                                             block_tables, scale=scale, workspace=workspace)
    return _paged.paged_decode_attention_ref(q, k_pool, v_pool, slots, positions,
                                             block_tables, scale=scale)


def ragged_prefill_attention(q, k_pool, v_pool, tile_slot, tile_pos0,
                             tile_valid, block_tables, tile: int,
                             scale: float | None = None, impl: str = "auto"):
    """Tiled prefill attention over the blocked pool: ``q`` holds tile-aligned
    prefill tokens (one sequence per ``tile``-token tile, consecutive
    positions, rows past ``tile_valid`` padding, which come out as zeros)."""
    if getattr(k_pool, "is_quantized_kv", False):
        fn = _paged.quantized_prefill_attention
    else:
        fn = _pick(impl, _paged.ragged_prefill_attention, _paged.ragged_prefill_attention_ref)
    return fn(q, k_pool, v_pool, tile_slot, tile_pos0, tile_valid,
              block_tables, tile, scale=scale)


def apply_rope(q, k, positions, theta: float = 10000.0):
    """Half-split rotary position embedding with fp32 angles.

    q/k: [B, S, H, D]; positions: [B, S] absolute positions."""
    d = q.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=q.device) / half))
    angles = positions[..., None].float() * freqs          # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]                 # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)
