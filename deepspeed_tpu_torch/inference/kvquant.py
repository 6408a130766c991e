"""Low-bit paged KV cache (counterpart of
``deepspeed_tpu/inference/kvquant.py``): the *block* is the unit of
quantization wherever it lives, the device pool, the prefix cache's
retained set, the host and disk tiers and the handoff record.

A quantized pool is a ``QuantizedKV`` pair ``(q, s)``: the payload in a
1-byte storage dtype and one fp16 scale per (token row, KV head). Rows
quantize once, at the paged write (``models/paged.write_kv_paged``), and
each row on its own, so rewriting a row never re-rounds a neighbour; the
attention of a quantized pool dequantizes in its gather (``ops/attention``).

Codecs: ``int8`` (symmetric absmax per row and head onto +-127) and
``fp8`` (``torch.float8_e4m3fn``, the same absmax pre-scale onto +-448).
Their bytes equal the JAX package's: the scale is rounded to fp16 before
the divide, the quotient clipped to +-qmax, then rounded (int8) or cast
(fp8). A row whose absmax is above 0 but whose scale rounds to 0 in fp16
divides by 0 there: its int8 payload stores what the reference's XLA
conversion stores, 0 for 0 / 0 and +-127 for the rest, and its fp8 payload
the reference's CPU bytes, the negative NaN (0xFF) for 0 / 0, on every
device.

``parse_quant`` reads the one low-bit config surface, ``RaggedConfig.quant``;
``token_match_rate`` and ``drift_verdict`` are the drift budget's gauge and
gate. ``load_record`` unpickles a handoff or tier record in which a JAX
engine's ``QuantizedKV`` becomes this package's, without importing the JAX
package. The quantized logits all-gather of tensor-parallel serving waits
for the port's tensor parallelism (``ROADMAP.md`` queue 1 item 12).
"""

from __future__ import annotations

import io
import pickle
from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.quantizer import true_div

DRIFT_BUDGET = {
    # greedy continuations: fraction of position-wise matching tokens
    # (prefix agreement) against the fp path
    "greedy_match_min": 0.95,
    # |accept_rate(quant) - accept_rate(fp)| of speculative drafts
    "spec_accept_drift_max": 0.02,
}


class KVQCodec(NamedTuple):
    """One KV-block codec: 1-byte storage and per-row-per-head scales."""

    name: str
    storage: torch.dtype  # the payload's
    scale: torch.dtype    # the scales'
    qmax: float           # absmax maps onto +-qmax


CODECS = {
    "int8": KVQCodec("int8", torch.int8, torch.float16, 127.0),
    # e4m3's largest finite value is 448
    "fp8": KVQCodec("fp8", torch.float8_e4m3fn, torch.float16, 448.0),
}


def get_codec(name: str) -> KVQCodec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown KV codec {name!r}; supported: {sorted(CODECS)}") from None


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its bytes as uint8 for fp8 (indexing, copies and
    concatenation move fp8 payloads as bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


# --------------------------------------------------------------- row codec
def quantize_kv_rows(x: torch.Tensor, codec: KVQCodec):
    """Quantize KV rows along the last (head dim) axis: ``x [..., D] ->
    (q [..., D] in codec.storage, s [...] fp16)``. The scale is rounded to
    fp16 before the divide, so quantize and dequantize use one value."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, true_div(amax, codec.qmax), 1.0).to(codec.scale)
    y = (xf / s.float()[..., None]).clamp(-codec.qmax, codec.qmax)
    if codec.name == "int8":
        # 0 / 0 (a scale that rounded to 0) stores 0, as XLA converts NaN
        return torch.round(y).nan_to_num_(0.0).to(torch.int8), s
    # 0 / 0's NaN: its sign, and what a cast keeps of it, differ by device;
    # store the reference's CPU byte, 0xFF, on every device
    q = y.nan_to_num(0.0).to(codec.storage).view(torch.uint8)
    return torch.where(y.isnan(), 0xFF, q).view(codec.storage), s


def dequantize_kv_rows(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of ``quantize_kv_rows``: the fp32 product rounded once to
    ``dtype`` (or written into ``out``, whose layout the product takes)."""
    if out is None:
        out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.dtype == torch.float8_e4m3fn:
        q = q.float()
    return torch.mul(q, s.float()[..., None], out=out)


# ------------------------------------------------------- record leaves
def leaf_to_torch(a):
    """A payload leaf as a CPU torch tensor (records hold numpy arrays); a
    ``QuantizedKV`` as it is (its unpickling made its leaves tensors)."""
    if isinstance(a, (torch.Tensor, QuantizedKV)):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def leaf_to_wire(a):
    """A payload leaf as a record pickles it: a numpy array, which the JAX
    package reads as its own; numpy has no bfloat16, so a bf16 leaf stays a
    CPU torch tensor (read back bit for bit by this package only). A
    ``QuantizedKV`` stays as it is: its pickling converts its leaves."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.clone()
        return a.numpy().copy()
    return a


# ------------------------------------------------------------- the pool
class QuantizedKV:
    """A quantized KV pool, or a layer or a block slice of one: the payload
    ``q`` and the scales ``s`` (``q``'s shape without its last dim), the
    codec's name and the compute dtype's name.

    - ``shape`` is the payload's (``shape[1]`` of a layer is the block size);
    - ``dtype`` is the COMPUTE dtype (the forward's activations);
    - ``nbytes`` is payload + scales;
    - ``pool[i]`` is layer ``i`` as views;
    - ``scatter_rows`` quantizes and writes rows IN PLACE: the captured
      graphs hold the pool's pointers (the JAX package's is functional).

    Pickled (handoff records, disk tiers) under the JAX package's state keys
    ``q``, ``s``, ``codec``, ``dtype``, every leaf a numpy array: an fp8
    payload as its e4m3fn bytes in uint8 (numpy has no float8, and torch's
    pickle does not read a float8 tensor back); unpickled, every leaf is a
    CPU tensor, and an fp8 record of the JAX package (``ml_dtypes`` arrays)
    reads as its bytes too."""

    is_quantized_kv = True

    def __init__(self, q, s, codec: str, dtype: str):
        self.q = q
        self.s = s
        self.codec = codec
        self._dtype_name = dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self._dtype_name)

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.s.nbytes)

    def leaves(self) -> list:
        return [self.q, self.s]

    def map(self, fn) -> "QuantizedKV":
        """A data movement ``fn`` (indexing, slicing, copies) of each leaf
        tensor; it sees an fp8 payload as its uint8 bytes."""
        return QuantizedKV(fn(_bits(self.q)).view(self.q.dtype), fn(self.s), self.codec,
                           self._dtype_name)

    def clone(self) -> "QuantizedKV":
        return QuantizedKV(self.q.clone(), self.s.clone(), self.codec, self._dtype_name)

    def __getitem__(self, i) -> "QuantizedKV":
        return QuantizedKV(self.q[i], self.s[i], self.codec, self._dtype_name)

    def __repr__(self):
        return (f"QuantizedKV(codec={self.codec!r}, shape={tuple(self.shape)}, "
                f"dtype={self._dtype_name})")

    def scatter_rows(self, blk, off, rows) -> "QuantizedKV":
        """Quantize new KV rows ``[T, Hkv, D]`` and write them into the
        ``(block, offset)`` cells of a layer's pool ``[NB, BS, Hkv, D]``, in
        place."""
        q_rows, s_rows = quantize_kv_rows(rows, get_codec(self.codec))
        _bits(self.q)[blk, off] = _bits(q_rows)
        self.s[blk, off] = s_rows
        return self

    def gather_dequant(self, tables) -> torch.Tensor:
        """The dequant in the gather: ``tables [n, MB]`` over a layer's pool
        ``[NB, BS, Hkv, D]`` -> fp32 ``[n, Hkv, MB BS, D]``, heads first for
        the attention's products (the JAX package returns ``[n, MB, BS,
        Hkv, D]``; the values are the same)."""
        n, mb = tables.shape
        _, bs, hkv, d = self.q.shape
        q = _bits(self.q)[tables].view(self.q.dtype)            # [n, MB, BS, Hkv, D]
        out = torch.empty((n, hkv, mb, bs, d), dtype=torch.float32, device=q.device)
        dequantize_kv_rows(q.permute(0, 3, 1, 2, 4), self.s[tables].permute(0, 3, 1, 2),
                           out=out)
        return out.view(n, hkv, mb * bs, d)

    def __getstate__(self):
        return {"q": leaf_to_wire(_bits(self.q)), "s": leaf_to_wire(self.s),
                "codec": self.codec, "dtype": self._dtype_name}

    def __setstate__(self, state):
        q = state["q"]
        if state["codec"] == "fp8":
            if not isinstance(q, torch.Tensor):
                q = np.asarray(q).view(np.uint8)
            q = leaf_to_torch(q).view(torch.float8_e4m3fn)
        self.q = leaf_to_torch(q)
        self.s = leaf_to_torch(state["s"])
        self.codec = state["codec"]
        self._dtype_name = state["dtype"]


def kv_leaves(pool) -> list:
    """The tensors of a pool or payload leaf: ``q`` and ``s`` of a
    ``QuantizedKV``, else the leaf itself."""
    return pool.leaves() if isinstance(pool, QuantizedKV) else [pool]


def map_kv(fn, pool):
    """``fn`` of a pool or payload leaf, leaf by leaf."""
    return pool.map(fn) if isinstance(pool, QuantizedKV) else fn(pool)


def cat_kv(parts: list, dim: int):
    """Payload leaves of one name (``QuantizedKV`` or tensors) concatenated
    along ``dim``."""
    first = parts[0]
    if not isinstance(first, QuantizedKV):
        return torch.cat([leaf_to_torch(p) for p in parts], dim=dim)
    q = torch.cat([_bits(p.q) for p in parts], dim=dim).view(first.q.dtype)
    return QuantizedKV(q, torch.cat([p.s for p in parts], dim=dim), first.codec,
                       first._dtype_name)


def copy_into(pool, dim: int, index: torch.Tensor, src) -> None:
    """``pool.index_copy_(dim, index, src)`` leaf by leaf (fp8 as bytes),
    ``src``'s CPU tensors moved to the pool's device."""
    for dst, val in zip(kv_leaves(pool), kv_leaves(src)):
        _bits(dst).index_copy_(dim, index, _bits(val.to(dst.dtype)).to(dst.device))


# ------------------------------------------------------- pool construction
def build_quantized_paged_cache(init_fn, num_blocks: int, block_size: int, dtype,
                                codec: KVQCodec, device) -> dict:
    """The quantized pool, allocated at storage precision directly:
    ``init_fn`` (the model's ``init_paged_cache_fn``) runs on the meta
    device for its shapes, so no fp pool is allocated, even once."""
    struct = init_fn(num_blocks, block_size, dtype, "meta")
    name = str(dtype).replace("torch.", "")
    return {k: QuantizedKV(torch.zeros(a.shape, dtype=codec.storage, device=device),
                           torch.zeros(a.shape[:-1], dtype=codec.scale, device=device),
                           codec.name, name)
            for k, a in struct.items() if isinstance(a, torch.Tensor)}


def paged_block_bytes(init_fn, num_blocks: int, block_size: int, dtype) -> int:
    """Bytes one UNQUANTIZED block (every layer, k and v) costs at
    ``dtype``, from the shapes alone (meta tensors)."""
    struct = init_fn(num_blocks, block_size, dtype, "meta")
    return sum(int(a.shape[0]) * int(np.prod(a.shape[2:])) * a.element_size()
               for a in struct.values() if isinstance(a, torch.Tensor))


# ----------------------------------------------------------- config surface
class ParsedQuant(NamedTuple):
    kv: KVQCodec | None  # KV-block codec (None: fp pool)
    woq_bits: int        # weight-only quantization bits (0: dense weights)
    qcol: bool           # quantize the tensor-parallel inference collectives


def parse_quant(spec) -> ParsedQuant:
    """Parse ``RaggedConfig.quant``: ``"off"`` | ``"int8"`` | ``"fp8"`` |
    ``"woq8"`` | ``"woq4"`` | ``"qcol"`` joined with ``+`` (e.g.
    ``"int8+woq8"``); None or empty means off."""
    if spec is None:
        return ParsedQuant(None, 0, False)
    if not isinstance(spec, str):
        raise ValueError(f"quant must be a string, got {type(spec).__name__}")
    kv, woq, qcol = None, 0, False
    for part in spec.split("+"):
        part = part.strip().lower()
        if part in ("", "off", "none"):
            continue
        if part in CODECS:
            if kv is not None:
                raise ValueError(f"quant={spec!r}: more than one KV codec")
            kv = CODECS[part]
        elif part in ("woq8", "woq4"):
            if woq:
                raise ValueError(f"quant={spec!r}: more than one woq spec")
            woq = int(part[3:])
        elif part == "qcol":
            qcol = True
        else:
            raise ValueError(
                f"quant={spec!r}: unknown component {part!r}; grammar: "
                "off | int8 | fp8 | woq8 | woq4 | qcol joined with '+'")
    return ParsedQuant(kv, woq, qcol)


# ------------------------------------------------------------ drift metrics
def token_match_rate(want: dict, got: dict) -> float:
    """Greedy drift gauge: position-wise prefix agreement of generated token
    lists, averaged over tokens (1.0: identical)."""
    total = match = 0
    for uid, ref in want.items():
        have = got.get(uid) or []
        total += len(ref)
        for a, b in zip(ref, have):
            if a != b:
                break
            match += 1
    return match / total if total else 1.0


def drift_verdict(greedy_match: float, spec_accept_drift: float | None,
                  budget: dict | None = None) -> dict:
    """Measured drift against ``DRIFT_BUDGET``."""
    b = dict(DRIFT_BUDGET, **(budget or {}))
    ok = greedy_match >= b["greedy_match_min"]
    if spec_accept_drift is not None:
        ok = ok and spec_accept_drift <= b["spec_accept_drift_max"]
    return {
        "ok": bool(ok),
        "greedy_token_match_rate": round(float(greedy_match), 4),
        "spec_accept_rate_drift": (None if spec_accept_drift is None
                                   else round(float(spec_accept_drift), 4)),
        "budget": b,
    }


# ------------------------------------------------------------------ records
_JAX_CLASSES = {("deepspeed_tpu.inference.kvquant", "QuantizedKV"): QuantizedKV}


class _RecordUnpickler(pickle.Unpickler):
    """Maps the JAX package's ``QuantizedKV`` to this one, without importing
    the JAX package, and refuses any other global of it."""

    def find_class(self, module, name):
        if module.split(".")[0] == "deepspeed_tpu":
            cls = _JAX_CLASSES.get((module, name))
            if cls is None:
                raise pickle.UnpicklingError(
                    f"record refers to {module}.{name} of the JAX package")
            return cls
        return super().find_class(module, name)


def load_record(body: bytes):
    """``pickle.loads`` of a record body written by either package."""
    return _RecordUnpickler(io.BytesIO(body)).load()
