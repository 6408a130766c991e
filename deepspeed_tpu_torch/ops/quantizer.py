"""Block quantization, int8 and int4 with symmetric per-block scales
(counterpart of ``deepspeed_tpu/ops/quantizer.py``): the weight-only
quantization (WOQ) of the serving engines. The row and sign codecs of the
reference's quantized collectives come with multi-GPU training
(``ROADMAP.md`` queue 1 item 10).

The reference leaves these to XLA, so they are plain torch here. Their
outputs equal the JAX package's bit for bit, on the CPU and on the card:
IEEE fp32 divides (``true_div``), round half to even, int4 packed two to an
int8 (the low nibble from the even index, the high from the odd one).

``QuantizedWeight`` is a weight kept quantized in a parameter dict. A
stacked layer weight keeps its leading layer dim on ``values`` and
``scales`` (``shape`` is the per-layer shape), and ``w[i]`` is layer ``i``'s
``QuantizedWeight`` as views, which the models' layer loops slice; each
layer dequantizes its weights at its head (``dequantize_layer``), so the
dense copies live one layer at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE divide on every device: divided by a Python
    scalar, a CUDA tensor is multiplied by the scalar's reciprocal, which
    can move the last bit."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


class QuantizedTensor(NamedTuple):
    values: torch.Tensor  # int8 payload (int4: packed two a byte)
    scales: torch.Tensor  # fp32 per-block scales
    shape: tuple          # original shape
    bits: int             # 8 or 4
    block: int


def _to_blocks(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block), pad


def _from_blocks(vals: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """Inverse of ``_to_blocks``: drop the padding, restore the shape."""
    size = 1
    for s in shape:
        size *= s
    return vals.reshape(-1)[:size].reshape(shape).to(dtype)


def quantize(x: torch.Tensor, bits: int = 8, block: int = 256) -> QuantizedTensor:
    """Symmetric per-block quantization: ``scale = max(absmax, 1e-12) /
    qmax`` per block of the flattened (zero-padded) tensor, ``q =
    clip(round(x / scale), -qmax, qmax)``."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    blocks, _ = _to_blocks(x.float(), block)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = true_div(absmax.clamp_min(1e-12), qmax)
    q = torch.round(blocks / scale).clamp_(-qmax, qmax).to(torch.int8)
    if bits == 4:
        lo = q[:, 0::2] & 0x0F
        hi = (q[:, 1::2] & 0x0F) << 4
        q = lo | hi
    return QuantizedTensor(values=q, scales=scale[:, 0], shape=tuple(x.shape), bits=bits,
                           block=block)


def _unpack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 payload -> one int8 value an element (int4: sign-extended
    nibbles, low then high)."""
    if bits != 4:
        return q
    lo = (q << 4) >> 4  # int8 shifts: the left one wraps, the right one keeps the sign
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], -1)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``: the fp32 product of values and scales,
    rounded once to ``dtype``, in one pass (no fp32 copy of the weight)."""
    q = _unpack(qt.values, qt.bits)
    vals = torch.empty(q.shape, dtype=dtype, device=q.device)
    torch.mul(q, qt.scales[:, None], out=vals)  # int8 x fp32 computes in fp32
    return _from_blocks(vals, qt.shape, dtype)


# ------------------------------------------------------------- WOQ params
class QuantizedWeight:
    """A weight stored quantized in a parameter dict (weight-only
    quantization). ``values`` / ``scales`` are ``quantize``'s payload, with
    a leading layer dim for a stacked layer weight; ``shape`` is the
    per-layer (or whole) weight's shape."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor, shape, bits: int,
                 block: int):
        self.values = values
        self.scales = scales
        self.shape = tuple(shape)
        self.bits = int(bits)
        self.block = int(block)

    def __getitem__(self, i: int) -> "QuantizedWeight":
        """Layer ``i`` of a stacked weight, as views."""
        return QuantizedWeight(self.values[i], self.scales[i], self.shape, self.bits,
                               self.block)

    @property
    def nbytes(self) -> int:
        return int(self.values.nbytes) + int(self.scales.nbytes)

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.values.to(device), self.scales.to(device), self.shape,
                               self.bits, self.block)

    def __repr__(self):
        return (f"QuantizedWeight(bits={self.bits}, block={self.block}, shape={self.shape}, "
                f"values={tuple(self.values.shape)})")


def maybe_dequantize(w, dtype):
    """``w`` itself unless it is a ``QuantizedWeight``, which dequantizes to
    ``dtype``."""
    if not isinstance(w, QuantizedWeight):
        return w
    return dequantize(QuantizedTensor(w.values, w.scales, w.shape, w.bits, w.block), dtype)


def dequantize_layer(lp: dict, dtype) -> dict:
    """A layer's weight dict with every ``QuantizedWeight`` dequantized to
    ``dtype`` (the others as they are): the models call it at the head of a
    layer, so the dense copies live one layer at a time. A dict with no
    quantized weight (training, an fp engine) comes back as it is."""
    if not any(isinstance(v, QuantizedWeight) for v in lp.values()):
        return lp
    return {k: maybe_dequantize(v, dtype) for k, v in lp.items()}


def quantize_params(params: dict, bits: int = 8, block: int = 256,
                    skip: tuple = ("embed",), stacked_key: str = "layers") -> dict:
    """The floating matrices of a parameter dict as ``QuantizedWeight``.
    Under ``stacked_key`` the leaves carry a leading layer dim: those of
    ndim >= 3 quantize layer by layer (their norms, ndim 2, stay dense);
    outside it, 2-D leaves quantize whole. A leaf with a name of ``skip`` on
    its path stays dense (the embedding gather wants a plain tensor), and so
    does a leaf already quantized."""

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names | {k}) for k, v in tree.items()}
        stacked = stacked_key in names
        if (not isinstance(tree, torch.Tensor) or tree.dim() < (3 if stacked else 2)
                or not tree.is_floating_point() or names & set(skip)):
            return tree
        if not stacked:
            qt = quantize(tree, bits=bits, block=block)
            return QuantizedWeight(qt.values, qt.scales, qt.shape, bits, block)
        # layer by layer into preallocated stacks: one layer's fp32 transient
        first = quantize(tree[0], bits=bits, block=block)
        values = first.values.new_empty((tree.shape[0], *first.values.shape))
        scales = first.scales.new_empty((tree.shape[0], *first.scales.shape))
        values[0], scales[0] = first.values, first.scales
        for i in range(1, tree.shape[0]):
            qt = quantize(tree[i], bits=bits, block=block)
            values[i], scales[i] = qt.values, qt.scales
        return QuantizedWeight(values, scales, tree.shape[1:], bits, block)

    return walk(params, frozenset())


def params_nbytes(params) -> int:
    """Bytes of a parameter dict, dense and quantized leaves alike."""
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    return int(params.nbytes)
