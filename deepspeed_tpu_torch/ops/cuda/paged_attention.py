"""Paged attention over the blocked KV pool: the CUDA kernels and their plain
versions (counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``).

``paged_decode_attention``: per-token attention over each token's sequence
blocks (``csrc/paged_decode.cu``, replacing the Pallas ``_kernel``).
``ragged_prefill_attention``: tiled SplitFuse prefill, one KV-block fetch per
tile (``csrc/paged_prefill.cu``, replacing the Pallas ``_prefill_kernel``).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it computes the plain version. The plain versions
(``*_ref``) compute the same function in fp32 with torch ops: a gather
through the block table, a position mask and a softmax. They are the CPU
path and the oracle the kernels are held against on the card.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, and each
plain version its calls in ``<ref>.calls``; ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for fn in (paged_decode_attention, ragged_prefill_attention):
        fn.launches = 0
    for fn in (paged_decode_attention_ref, ragged_prefill_attention_ref):
        fn.calls = 0


# ----------------------------------------------------------------- plain
def paged_decode_attention_ref(q, k_pool, v_pool, slots, positions,
                               block_tables, scale: float | None = None):
    """[T, Hq, D] tokens -> [T, Hq, D]: token t attends keys 0..positions[t]
    of the sequence in table row slots[t]."""
    paged_decode_attention_ref.calls += 1
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.long()[slots.long()]                    # [T, MB]
    ctx_k = k_pool[tables].reshape(t, -1, hkv, d).float()         # [T, C, Hkv, D]
    ctx_v = v_pool[tables].reshape(t, -1, hkv, d).float()
    qg = (q.float() * scale).reshape(t, hkv, rep, d)
    scores = torch.einsum("tgrd,tcgd->tgrc", qg, ctx_k)           # [T, Hkv, rep, C]
    kpos = torch.arange(ctx_k.shape[1], device=q.device)
    visible = kpos[None, :] <= positions.long()[:, None]          # [T, C]
    scores = torch.where(visible[:, None, None, :], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("tgrc,tcgd->tgrd", p, ctx_v)
    return out.reshape(t, hq, d).to(q.dtype)


def ragged_prefill_attention_ref(q, k_pool, v_pool, tile_slot, tile_pos0,
                                 tile_valid, block_tables, tile: int,
                                 scale: float | None = None):
    """[NT*CT, Hq, D] tile-aligned prefill tokens -> outputs. Tile c holds
    query tokens at positions tile_pos0[c] + i for i < tile_valid[c]; the
    other rows (and all-pad tiles) give zeros, as the Pallas kernel does."""
    ragged_prefill_attention_ref.calls += 1
    n, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    rep = hq // hkv
    nt = n // tile
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = block_tables.long()[tile_slot.long()]                # [NT, MB]
    ctx_k = k_pool[tables].reshape(nt, -1, hkv, d).float()        # [NT, C, Hkv, D]
    ctx_v = v_pool[tables].reshape(nt, -1, hkv, d).float()
    qg = (q.float() * scale).reshape(nt, tile, hkv, rep, d)
    scores = torch.einsum("nigrd,ncgd->ngric", qg, ctx_k)         # [NT, Hkv, rep, CT, C]
    qi = torch.arange(tile, device=q.device)
    qpos = tile_pos0.long()[:, None] + qi[None, :]                # [NT, CT]
    valid = qi[None, :] < tile_valid.long()[:, None]              # [NT, CT]
    kpos = torch.arange(ctx_k.shape[1], device=q.device)
    visible = (kpos[None, None, :] <= qpos[:, :, None]) & valid[:, :, None]
    scores = torch.where(visible[:, None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("ngric,ncgd->nigrd", p, ctx_v)             # [NT, CT, Hkv, rep, D]
    out = torch.where(valid[:, :, None, None, None], out, 0.0)
    return out.reshape(n, hq, d).to(q.dtype)


paged_decode_attention_ref.calls = 0
ragged_prefill_attention_ref.calls = 0


# ---------------------------------------------------------------- kernels
def _check_pools(q, k_pool, v_pool):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"want q [T, Hq, D] and pools [NB, BS, Hkv, D]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q and pools of one dtype; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _, hq, d = q.shape
    hkv = k_pool.shape[2]
    if k_pool.shape[3] != d or hq % hkv:
        raise ValueError(f"head dims disagree: q {tuple(q.shape)}, pool {tuple(k_pool.shape)}")
    if (d * q.element_size()) % 16 or d > 128:
        raise ValueError(f"head dim {d} x {q.element_size()} B: the kernels take head "
                         "dims up to 128 whose rows are a multiple of 16 B")


def _meta(x, n: int, device, name: str):
    """Metadata vector as contiguous int32 on the kernel's device."""
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{name} must have shape [{n}], got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.int32).contiguous()


def _table(block_tables, device):
    if block_tables.dim() != 2:
        raise ValueError(f"block_tables must be 2-D, got {tuple(block_tables.shape)}")
    bt = block_tables.to(device=device, dtype=torch.int32)
    if bt.stride(1) != 1:
        bt = bt.contiguous()
    return bt


def _decode_lib():
    lib = _build.load("paged_decode")
    fn = lib.dstpu_paged_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _prefill_lib():
    lib = _build.load("paged_prefill")
    fn = lib.dstpu_paged_prefill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_pool, v_pool, slots, positions, block_tables,
                           scale: float | None = None):
    """[T, Hq, D] ragged tokens -> [T, Hq, D] attention outputs.

    ``k_pool``/``v_pool``: [NB, BS, Hkv, D]; ``block_tables``: [max_seqs+1,
    MB] mapping (slot, block ordinal) -> pool block id (the row stride is
    passed, so a column slice of the table needs no copy). Block ids and
    slots are trusted: the engine's scheduler produces them."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, slots, positions,
                                          block_tables, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_pools(q, k_pool, v_pool)
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    slots = _meta(slots, t, q.device, "slots")
    positions = _meta(positions, t, q.device, "positions")
    bt = _table(block_tables, q.device)
    out = torch.empty_like(q)
    if t == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rc = _decode_lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), slots.data_ptr(),
        positions.data_ptr(), bt.data_ptr(), bt.stride(0), out.data_ptr(),
        t, hq, hkv, d, bs, scale, _DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {rc}")
    paged_decode_attention.launches += 1
    return out


def ragged_prefill_attention(q, k_pool, v_pool, tile_slot, tile_pos0,
                             tile_valid, block_tables, tile: int,
                             scale: float | None = None):
    """Tiled prefill attention: [NT*CT, Hq, D] tile-aligned prefill tokens ->
    outputs; each CTA fetches a KV block once for 128 GQA rows of a tile
    (bf16, tensor cores) or 64 (fp32, CUDA cores).

    Scheduler contract (``inference/ragged.py``): each tile's tokens belong
    to ONE sequence at consecutive positions ``pos0..pos0+valid-1``; rows
    past ``valid`` are padding and come out as zeros; ``tile_valid == 0``
    marks an all-pad tile."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_ref(q, k_pool, v_pool, tile_slot,
                                            tile_pos0, tile_valid, block_tables,
                                            tile, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_pools(q, k_pool, v_pool)
    n, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    if tile <= 0 or n % tile:
        raise ValueError(f"{n} prefill rows are not a whole number of {tile}-row tiles")
    nt = n // tile
    tile_slot = _meta(tile_slot, nt, q.device, "tile_slot")
    tile_pos0 = _meta(tile_pos0, nt, q.device, "tile_pos0")
    tile_valid = _meta(tile_valid, nt, q.device, "tile_valid")
    bt = _table(block_tables, q.device)
    out = torch.empty_like(q)
    if nt == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rc = _prefill_lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tile_slot.data_ptr(),
        tile_pos0.data_ptr(), tile_valid.data_ptr(), bt.data_ptr(), bt.stride(0),
        out.data_ptr(), nt, hq, hkv, d, bs, tile, scale, _DTYPES[q.dtype],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_prefill kernel launch failed: cudaError_t {rc}")
    ragged_prefill_attention.launches += 1
    return out


paged_decode_attention.launches = 0
ragged_prefill_attention.launches = 0
