"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random`` with
``jax_threefry_partitionable`` on (the default of the JAX the reference
runs on): the port's copy of what ``deepspeed_tpu/inference/sampling.py``
uses, so a seeded request draws the reference's tokens.

- ``prng_key(seed)``: ``jax.random.PRNGKey`` (``jax/_src/prng.py
  threefry_seed``): ``[0, seed mod 2^32]`` for the 32-bit seeds JAX makes
  without x64;
- ``fold_in(key, data)``: the threefry hash of the counter pair
  ``(0, data)`` under ``key``;
- ``random_bits(key, shape)``: 32-bit words, ``bits1 ^ bits2`` of the hash
  of the 64-bit iota over ``shape`` (``_threefry_random_bits_partitionable``);
- ``uniform``, ``gumbel`` (``mode="low"``) and ``categorical`` (the
  Gumbel-max trick along the last axis), as ``jax/_src/random.py`` builds
  them in float32.

A key is an integer tensor ``[..., 2]`` on the caller's device; leading
dimensions are a batch of keys, each drawing its own ``shape``. The words
live in int64 tensors masked to 32 bits: ``torch.uint32`` lacks shifts and
multiplies on several backends. Nothing reads a value on the host and no
shape depends on data, so a CUDA graph can capture every function here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    """``x`` as 32-bit words in int64 (negative ints wrap, as a cast to
    uint32 does)."""
    if not torch.is_tensor(x):
        return int(x) & MASK
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; all broadcast. Returns the two output
    words."""
    k1, k2, x1, x2 = (_u32(v) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` [..., 2], ``data`` an int or an integer
    tensor broadcasting against ``key[..., 0]``; returns [..., 2]."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for every key of the batch
    ``key`` [..., 2]: int64 words, [..., *shape]."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("random_bits: more than 2^32 words need the high counter word")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(*batch, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*batch, *([1] * len(shape)))
    y1, y2 = threefry2x32(k1, k2, 0, lo)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the 23 high bits of a word as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval).
    Bit-exact where ``maxval - minval`` rounds to a power of two (the
    product is then exact, whether or not XLA fuses it into an FMA), as it
    does for every call the sampler makes."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 on the host, as
    # JAX converts them; no tensor is made, so a graph captures this
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * scale + lo, min=lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32, mode="low")``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32 logits:
    one key draws noise over the whole of ``logits``; a batch of keys
    ``[*B, 2]`` with logits ``[*B, V]`` draws each row from its own key, as
    ``jax.vmap`` of the one-row call does. Returns int64 indices."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
