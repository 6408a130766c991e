"""Paged attention over the blocked KV pool: the CUDA kernels and their plain
versions (counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``).

``paged_decode_attention``: per-token attention over each token's sequence
blocks, each context split across CTAs whose partial results are merged in
a fixed order (``csrc/paged_decode.cu``, replacing the Pallas ``_kernel``).
``ragged_prefill_attention``: tiled SplitFuse prefill, one KV-block fetch per
tile (``csrc/paged_prefill.cu``, replacing the Pallas ``_prefill_kernel``).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it computes the plain version. The plain versions
(``*_ref``) compute the same function in fp32 with torch ops: a gather
through the block table, a position mask and a softmax. They are the CPU
path and the oracle the kernels are held against on the card.

The kernels take fp32 or bf16 pools and every head dim ``supports`` allows;
above 256 both wrappers launch the wide kernels of ``csrc/wide_head.cu``
(one query row a warp, the head dim streamed in 256-wide chunks; above 1024
the rows' fp32 vectors in a workspace the wrapper allocates).

Each wrapper counts its kernel launches in ``<wrapper>.launches``, and each
plain version its calls in ``<ref>.calls``; ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from deepspeed_tpu_torch.ops.cuda import _build
# the paged kernels take the flash kernels' head dims: d % 8 == 0 (rows of
# 16 bytes), d >= 8, fp32 or bf16
from deepspeed_tpu_torch.ops.cuda.flash_attention import (WIDE_HEAD_DIM, WIDE_ROWS, _ptr,
                                                          supports, wide_workspace)

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GQA_REP = 32  # query heads per KV head the decode kernel takes
# the decode kernel aims at about this many (token, KV head, split) CTAs an SM
_DECODE_CTAS_PER_SM = 4


def decode_splits(tokens: int, hkv: int, table_width: int, sms: int) -> int:
    """How many splits the decode kernel cuts each token's context into,
    from sizes the host knows without reading the card (never the
    positions): enough (token, KV head, split) CTAs for about
    ``_DECODE_CTAS_PER_SM`` an SM, each split owning the same whole number
    of the table's blocks and none owning only columns past the table.

    It never gives more than ``ceil(C sms / (tokens hkv))`` splits (C =
    ``_DECODE_CTAS_PER_SM``), and more than one only when ``tokens hkv <
    C sms``: so ``tokens hkv splits < 2 C sms`` whenever the partials are
    used, whatever the token count, which bounds ``DecodeWorkspace``."""
    want = -(-_DECODE_CTAS_PER_SM * sms // max(1, tokens * hkv))
    per_split = -(-table_width // max(1, min(want, table_width)))
    return -(-table_width // per_split)


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
    if not supports(d, q.dtype):
        raise ValueError(f"head dim {d}: the kernels take head dims d % 8 == 0, d >= 8")


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
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                       i, i, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_sizes(t: int, hq: int, hkv: int, d: int, splits: int) -> tuple[int, int]:
    """(fp32 partials, int32 counters) a call of ``splits`` > 1 splits uses:
    m and l per (query row, split), then from the next multiple of 4 floats
    acc[d] per (query row, split); a counter per (token, KV head)."""
    rows = t * hq * splits
    return -(-2 * rows // 4) * 4 + rows * d, t * hkv


def _workspace_sizes(hq: int, hkv: int, d: int, sms: int) -> tuple[int, int]:
    """(fp32 partials, int32 counters) that hold every split call
    ``decode_splits`` allows at these sizes and any token count: such a call
    has tokens hkv splits < 2 C sms (C = ``_DECODE_CTAS_PER_SM``), so fewer
    than 2 C sms hq / hkv query rows, and tokens hkv < C sms counters."""
    ctas = _DECODE_CTAS_PER_SM * sms
    return _decode_sizes(1, 2 * ctas * (hq // hkv), 1, d, 1)[0], ctas


class DecodeWorkspace:
    """The split decode's scratch on one device: fp32 partials (m, l,
    acc[d] per query row and split) and int32 counters (one per token and
    KV head, 0 between calls: the kernel resets them).

    Sized once, for every call that ``decode_splits`` allows with ``hq``
    query heads, ``hkv`` KV heads and head dim up to ``d`` at any token
    count, and never resized: a CUDA graph that captured a call replays on
    these buffers for as long as the workspace lives. Calls that share a
    workspace must run in order (one stream); its owner, the paged cache
    of an engine, runs one step at a time."""

    def __init__(self, device, hq: int, hkv: int, d: int):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the decode workspace lives on a CUDA device, not {device}")
        if hq % hkv:
            raise ValueError(f"{hq} query heads are not a multiple of {hkv} KV heads")
        self.hq, self.hkv, self.d = hq, hkv, d
        n_part, n_counters = _workspace_sizes(hq, hkv, d, _sm_count(device.index or 0))
        self.part = torch.empty(n_part, dtype=torch.float32, device=device)
        self.counters = torch.zeros(n_counters, dtype=torch.int32, device=device)

    def buffers(self, device, t: int, hq: int, hkv: int, d: int, splits: int):
        """(partials, counters) for a call, or ValueError if it does not fit."""
        n_part, n_counters = _decode_sizes(t, hq, hkv, d, splits)
        if (device != self.part.device or n_part > self.part.numel()
                or n_counters > self.counters.numel()):
            raise ValueError(
                f"decode workspace for Hq {self.hq}, Hkv {self.hkv}, d <= {self.d} on "
                f"{self.part.device} does not fit a call of {t} tokens, Hq {hq}, Hkv {hkv}, "
                f"d {d}, {splits} splits on {device}")
        return self.part, self.counters


def _wide_lib(symbol: str, n_int: int):
    """A paged entry point of ``csrc/wide_head.cu``: the pools' and
    metadata's pointers, the table's row stride, the output, ``n_int``
    sizes, the scale, dtype, device, stream and row-vector workspace."""
    fn = getattr(_build.load("wide_head"), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr = 6 if symbol.endswith("decode") else 7
        fn.argtypes = [p] * n_ptr + [i, p] + [i] * n_int + [ctypes.c_float, i, i, p, p]
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
                           scale: float | None = None,
                           workspace: DecodeWorkspace | None = None):
    """[T, Hq, D] ragged tokens -> [T, Hq, D] attention outputs.

    ``k_pool``/``v_pool``: [NB, BS, Hkv, D]; ``block_tables``: [max_seqs+1,
    MB] mapping (slot, block ordinal) -> pool block id (the row stride is
    passed, so a column slice of the table needs no copy). Block ids and
    slots are trusted: the engine's scheduler produces them.

    Each token's context is cut into ``decode_splits`` runs of whole blocks
    of the table; the call reads nothing back from the card. With a
    ``workspace`` (``DecodeWorkspace``, owned by the caller) it allocates
    nothing but its output, so a CUDA graph that captures it replays on
    buffers that outlive it; without one, a call whose contexts are split
    takes its partials and counters from the caching allocator."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, slots, positions,
                                          block_tables, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_pools(q, k_pool, v_pool)
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    if hq // hkv > MAX_GQA_REP:
        raise ValueError(f"{hq // hkv} query heads per KV head; the decode kernel takes up "
                         f"to {MAX_GQA_REP}")
    slots = _meta(slots, t, q.device, "slots")
    positions = _meta(positions, t, q.device, "positions")
    bt = _table(block_tables, q.device)
    out = torch.empty_like(q)
    if t == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if d > WIDE_HEAD_DIM:
        ws = wide_workspace(q.device, d, 2, t * hkv * -(-(hq // hkv) // WIDE_ROWS))
        rc = _wide_lib("dstpu_wide_paged_decode", 5)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), slots.data_ptr(),
            positions.data_ptr(), bt.data_ptr(), bt.stride(0), out.data_ptr(), t, hq, hkv, d,
            bs, scale, _DTYPES[q.dtype], q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream, _ptr(ws))
        if rc:
            raise RuntimeError(f"wide paged_decode kernel launch failed: cudaError_t {rc}")
        paged_decode_attention.launches += 1
        return out
    mb = bt.shape[1]
    splits = decode_splits(t, hkv, mb, _sm_count(q.device.index or 0))
    per_split = -(-mb // splits)
    part = counters = None
    if splits > 1 and workspace is not None:
        part, counters = workspace.buffers(q.device, t, hq, hkv, d, splits)
    elif splits > 1:
        n_part, n_counters = _decode_sizes(t, hq, hkv, d, splits)
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
        counters = torch.zeros(n_counters, dtype=torch.int32, device=q.device)
    rc = _decode_lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), slots.data_ptr(),
        positions.data_ptr(), bt.data_ptr(), bt.stride(0), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), t, hq, hkv, d, bs, per_split,
        splits, scale, _DTYPES[q.dtype], q.device.index or 0,
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
    wide = d > WIDE_HEAD_DIM
    # held until the launch: the kernel writes it
    ws = wide_workspace(q.device, d, 2, nt * -(-tile // WIDE_ROWS) * hq) if wide else None
    launch = _wide_lib("dstpu_wide_paged_prefill", 6) if wide else _prefill_lib()
    rc = launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tile_slot.data_ptr(),
        tile_pos0.data_ptr(), tile_valid.data_ptr(), bt.data_ptr(), bt.stride(0),
        out.data_ptr(), nt, hq, hkv, d, bs, tile, scale, _DTYPES[q.dtype],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
        *((_ptr(ws),) if wide else ()))
    if rc:
        raise RuntimeError(f"paged_prefill kernel launch failed: cudaError_t {rc}")
    ragged_prefill_attention.launches += 1
    return out


paged_decode_attention.launches = 0
ragged_prefill_attention.launches = 0
