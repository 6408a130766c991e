"""Flash attention for training: the CUDA kernels, their plain versions and
the autograd function (counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py``).

Kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``):

- ``flash_attention_fwd`` -> ``(o, lse)``, replacing the Pallas ``_fwd_kernel``;
- ``flash_attention_dkdv`` -> ``(dk, dv)``, replacing ``_dkdv_kernel`` (the
  GQA sum over each KV head's q-heads happens inside the kernel);
- ``flash_attention_dq`` -> ``dq``, replacing ``_dq_kernel``.

All three do far more flops than bytes at training shapes, so the tensor
cores' rate bounds them. In bf16 at head dims 64 and 128 each runs
warp-specialised ``wgmma`` on Hopper: a producer warp streams tiles by TMA
through a ring in shared memory, two consumer warpgroups multiply; operands
are read through 4-D tensor maps (``tma_layout``) and nothing is staged
transposed. In fp32, and in bf16 at every other head dim, they run
CUDA-core FMAs (fp32 checks at 1e-4 rule out TF32) compiled for the padded
head dims 64, 128 and 256: loads zero-fill past the head dim and stores are
masked to it. Above 256 the wide kernels run (``csrc/wide_head.cu``: one row
a warp, the head dim streamed in 256-wide chunks; above 1024 a row's fp32
vectors live in a workspace the wrapper allocates, ``wide_workspace``).
``supports`` says which head dims the kernels take.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it computes the plain version. The plain versions compute the same
function in fp32 with torch ops: ``flash_attention_fwd_ref`` and
``flash_attention_bwd_ref`` (a port of ``_fa_bwd_xla``). They are the CPU
path and the oracle the kernels are held against on the card.

Causal semantics are the Pallas kernel's: a query at position i sees keys
0..i, both counted from 0, also when Sq != Skv (the JAX package's
``xla_attention`` and ``_fa_bwd_xla`` align the queries with the END of the
keys instead; the two agree when Sq == Skv, which training always has).

Layouts: q, o, dO [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] (Hq % Hkv == 0);
lse [B, Hq, Sq] fp32. The kernels read q, k, v and dO through their strides
(any batch, sequence and head strides, head dim contiguous), take fp32 or
bf16 and every head dim the reference's Pallas kernels take (``supports``),
and handle any sequence length.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, each
plain version its calls in ``<ref>.calls``; ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WIDE_HEAD_DIM = 256  # above this head dim the wide kernels (csrc/wide_head.cu) run
# above this head dim the wide kernels keep a CTA's row vectors in global memory
WIDE_SHARED_HEAD_DIM = 1024
WIDE_ROWS = 8  # rows a wide kernel's CTA owns, one a warp
WGMMA_HEAD_DIMS = (64, 128)  # bf16 head dims the wgmma kernels serve


def supports(d: int, dtype) -> bool:
    """Whether the kernels take head dim ``d`` in ``dtype``: fp32 or bf16,
    ``d % 8 == 0`` and ``d >= 8``, as the reference's ``_supported`` (every
    row a multiple of 16 bytes)."""
    return dtype in _DTYPES and d % 8 == 0 and d >= 8


def wide_workspace(device, d: int, vectors: int, ctas: int) -> torch.Tensor | None:
    """A wide kernel's fp32 row vectors above ``WIDE_SHARED_HEAD_DIM``, where
    a CTA's would outgrow shared memory: ``vectors`` [8][d] arrays for each
    of the launch's ``ctas`` CTAs (forward, decode, prefill 2; dQ 3; dK/dV
    4). None at smaller head dims, whose vectors stay in shared memory."""
    if d <= WIDE_SHARED_HEAD_DIM:
        return None
    return torch.empty(ctas * vectors * WIDE_ROWS * d, dtype=torch.float32, device=device)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def reset_counts() -> None:
    for fn in (flash_attention_fwd, flash_attention_dkdv, flash_attention_dq):
        fn.launches = 0
    for fn in (flash_attention_fwd_ref, flash_attention_bwd_ref):
        fn.calls = 0


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _visible(sq: int, sk: int, device) -> torch.Tensor:
    """[Sq, Sk] causal mask of the Pallas kernel: q_pos >= k_pos from 0."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


# ----------------------------------------------------------------- plain
def flash_attention_fwd_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain fp32 version of the forward: ``(o in q's dtype, lse [B, Hq, Sq])``."""
    flash_attention_fwd_ref.calls += 1
    scale = _scale(q, scale)
    n_rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    if causal:
        s = torch.where(_visible(q.shape[1], k.shape[1], q.device), s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)         # [B, H, Sq, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / safe_l.permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), lse


def _bwd_from_delta(q, k, v, lse, delta, do, causal, scale):
    """dq, dk, dv from the saved lse and delta = rowsum(dO * O) [B, Hq, Sq]."""
    scale = _scale(q, scale)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_visible(sq, sk, q.device), s, _NEG_INF)
    p = torch.exp(s - lse[..., None])                              # [B, H, Sq, Sk]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if n_rep > 1:
        dk = dk.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
        dv = dv.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(dO * O) in fp32, [B, Hq, Sq]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            scale: float | None = None):
    """Plain fp32 version of the backward (``_fa_bwd_xla``): ``(dq, dk, dv)``
    in the dtypes of q, k and v."""
    flash_attention_bwd_ref.calls += 1
    return _bwd_from_delta(q, k, v, lse, _delta(o, do), do, causal, scale)


flash_attention_fwd_ref.calls = 0
flash_attention_bwd_ref.calls = 0


# ---------------------------------------------------------------- kernels
def _check(q, k, v, *others):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q, k, v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not supports(d, q.dtype):
        raise ValueError(f"flash attention kernels take head dims d % 8 == 0, d >= 8; "
                         f"got {d}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v), *others):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1 or any(x.stride(i) % vec for i in range(3)) or x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and every row "
                             f"16-byte aligned; strides {x.stride()}")


def _strides(*tensors) -> ctypes.Array:
    vals = [x.stride(i) for x in tensors for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


def tma_layout(x) -> list[int]:
    """The 4-D tensor map the bf16 kernels read a [B, S, H, D] tensor
    through: dims innermost first (D, S, H, B), then the byte strides of S,
    H and B. TMA needs those strides to be multiples of 16 bytes."""
    b, s, h, d = x.shape
    if x.stride(3) != 1:
        raise ValueError(f"the head dim must be contiguous; strides {x.stride()}")
    strides = [x.stride(i) * x.element_size() for i in (1, 2, 0)]
    if any(st % 16 for st in strides):
        raise ValueError(f"tensor map strides must be multiples of 16 bytes; got {strides}")
    return [d, s, h, b, *strides]


def kernel_layouts(*tensors) -> ctypes.Array | None:
    """The tensor maps of ``tensors`` in turn (7 values each) for the bf16
    wgmma kernels (head dims 64 and 128), which read their inputs by TMA;
    None for the CUDA-core kernels, which read through the element strides."""
    x = tensors[0]
    if x.dtype != torch.bfloat16 or x.shape[-1] not in WGMMA_HEAD_DIMS:
        return None
    vals = [v for x in tensors for v in tma_layout(x)]
    return (ctypes.c_ulonglong * len(vals))(*vals)


def _fn(lib_name: str, symbol: str, n_ptr: int):
    fn = getattr(_build.load(lib_name), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def wide_fn(symbol: str, n_ptr: int):
    """An entry point of ``csrc/wide_head.cu``, the kernels of head dims
    above ``WIDE_HEAD_DIM``: ``n_ptr`` pointers, 7 ints, the scale, dtype,
    device, stream and row-vector workspace (``wide_workspace``; the paged
    entry points set their own argtypes)."""
    fn = getattr(_build.load("wide_head"), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * 7 + [ctypes.c_float, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _device(x):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return x.device.index or 0


def flash_attention_fwd(q, k, v, causal: bool = True, scale: float | None = None):
    """Attention forward: ``(o [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32)``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    dev = _device(q)
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if d > WIDE_HEAD_DIM:
        ws = wide_workspace(q.device, d, 2, -(-sq // WIDE_ROWS) * hq * b)
        rc = wide_fn("dstpu_wide_flash_fwd", 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), b, sq, skv, hq, hkv, d, int(causal), _scale(q, scale),
            _DTYPES[q.dtype], dev, _stream(q), _ptr(ws))
    else:
        rc = _fn("flash_fwd", "dstpu_flash_fwd", 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), kernel_layouts(q, k, v), b, sq, skv, hq, hkv, d, int(causal),
            _scale(q, scale), _DTYPES[q.dtype], dev, _stream(q))
    if rc:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    flash_attention_fwd.launches += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _check(q, k, v, ("do", do))
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype} vs "
                         f"{tuple(q.shape)} {q.dtype}")
    b, sq, hq, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, hq, sq) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {hq}, {sq}]")


def flash_attention_dkdv(q, k, v, do, lse, delta, causal: bool = True,
                         scale: float | None = None):
    """``(dk, dv)`` in k's dtype, summed over each KV head's q-heads."""
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, lse, delta, do, causal, scale)[1:]
    dev = _device(q)
    _bwd_inputs(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dk, dv))
    sizes = (b, sq, skv, hq, hkv, d, int(causal), _scale(q, scale), _DTYPES[q.dtype], dev,
             _stream(q))
    if d > WIDE_HEAD_DIM:
        ws = wide_workspace(q.device, d, 4, -(-skv // WIDE_ROWS) * hkv * b)
        rc = wide_fn("dstpu_wide_flash_dkdv", 9)(*ptrs, *sizes, _ptr(ws))
    else:
        rc = _fn("flash_bwd", "dstpu_flash_dkdv", 9)(*ptrs, kernel_layouts(q, k, v, do), *sizes)
    if rc:
        raise RuntimeError(f"flash_dkdv kernel launch failed: cudaError_t {rc}")
    flash_attention_dkdv.launches += 1
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True,
                       scale: float | None = None):
    """``dq`` in q's dtype."""
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, lse, delta, do, causal, scale)[0]
    dev = _device(q)
    _bwd_inputs(q, k, v, do, lse, delta)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq))
    sizes = (b, sq, skv, hq, hkv, d, int(causal), _scale(q, scale), _DTYPES[q.dtype], dev,
             _stream(q))
    if d > WIDE_HEAD_DIM:
        ws = wide_workspace(q.device, d, 3, -(-sq // WIDE_ROWS) * hq * b)
        rc = wide_fn("dstpu_wide_flash_dq", 8)(*ptrs, *sizes, _ptr(ws))
    else:
        rc = _fn("flash_bwd", "dstpu_flash_dq", 8)(*ptrs, kernel_layouts(q, k, v, do), *sizes)
    if rc:
        raise RuntimeError(f"flash_dq kernel launch failed: cudaError_t {rc}")
    flash_attention_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_dkdv.launches = 0
flash_attention_dq.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: float | None = None):
    """``(dq, dk, dv)``: delta = rowsum(dO * O) in fp32 (a torch reduction,
    as the reference leaves it to XLA), then the dK/dV and dQ wrappers."""
    if do.stride(-1) != 1 or do.data_ptr() % 16:
        do = do.contiguous()
    delta = _delta(o, do)
    dk, dv = flash_attention_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Counterpart of ``flash_attention.defvjp(_fa_fwd, _fa_bwd)``: saves
    ``(q, k, v, o, lse)`` and runs the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """Differentiable flash attention: [B, Sq, Hq, D] outputs."""
    return FlashAttention.apply(q, k, v, causal, scale)
