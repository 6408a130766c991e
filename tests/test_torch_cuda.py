"""The port's CUDA kernels (paged decode, tiled prefill, flash-attention
forward, dK/dV and dQ) against their plain PyTorch versions, on the card.

Marked ``cuda``; without a CUDA device every test skips (decided in the
``cuda`` fixture, never at import). On the H100:

    python3 -m pytest -m cuda tests/test_torch_cuda.py

Table entries past each sequence's last needed block hold an id far outside
the pool: the kernels must never read them (the plain versions, which gather
whole rows, get the same table with those entries zeroed).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa

pytestmark = pytest.mark.cuda

STALE = 1 << 30  # a block id no pool has: reading it faults

# (Hq, Hkv, D, NB, BS, MB): the layout of tests/unit/test_paged_attention.py,
# a GQA rep=4 case, the tiny engine of tests/test_torch_ragged.py, Llama-3-8B
SHAPES = {
    "unit_layout": (4, 2, 16, 16, 8, 4),
    "gqa4_d128": (8, 2, 128, 64, 32, 8),
    "tiny_engine": (4, 2, 8, 49, 4, 16),
    "llama3_8b": (32, 8, 128, 577, 32, 18),
}
# fp32 kernel vs fp32 plain: summation order only; bf16: both round the
# output to bf16 (one ulp at |x| ~ 1 is 2**-7) from the same bf16 inputs
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 flash outputs: ||got - want||_F / ||want||_F, the limit of
# chip_smoke.py's bf16 flash check (between a correct kernel, which rounds p
# and ds to bf16 before their products, and a softmax scale one bf16 ulp off)
FLASH_BF16_REL_FRO = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python3 -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 plain versions
    pa.reset_counts()
    fa.reset_counts()
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


def _pools(rng, shape, n_seqs, dtype, device):
    hq, hkv, d, nb, bs, mb = shape
    kp = torch.tensor(rng.normal(size=(nb, bs, hkv, d)), dtype=dtype, device=device)
    vp = torch.tensor(rng.normal(size=(nb, bs, hkv, d)), dtype=dtype, device=device)
    bt = np.zeros((n_seqs + 1, mb), np.int32)  # last row: all-scratch padding
    bt[:n_seqs] = rng.integers(1, nb, size=(n_seqs, mb))
    return kp, vp, bt


def _tables(bt, last_block, device):
    """(kernel table with stale ids past each row's last block, plain table
    with those entries zeroed)."""
    poisoned, clean = bt.copy(), bt.copy()
    for row, last in last_block.items():
        poisoned[row, last + 1:] = STALE
        clean[row, last + 1:] = 0
    return torch.tensor(poisoned, device=device), torch.tensor(clean, device=device)


def _decode_case(shape, dtype, device, seed=0):
    hq, hkv, d, nb, bs, mb = shape
    rng = np.random.default_rng(seed)
    n_seqs = 6
    kp, vp, bt = _pools(rng, shape, n_seqs, dtype, device)
    ctx = mb * bs
    # block edges, first and last positions, random ones, then padding tokens
    pos = [0, bs - 1, bs, 2 * bs - 1, ctx - 1] + list(rng.integers(0, ctx, 7))
    slots = [i % n_seqs for i in range(len(pos))]
    slots += [n_seqs] * 3
    pos += [0] * 3
    last = {}
    for s, p in zip(slots, pos):
        if s < n_seqs:
            last[s] = max(last.get(s, 0), p // bs)
    q = torch.tensor(rng.normal(size=(len(pos), hq, d)), dtype=dtype, device=device)
    bt_k, bt_p = _tables(bt, last, device)
    slots = torch.tensor(slots, dtype=torch.int32, device=device)
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    return (q, kp, vp, slots, pos), bt_k, bt_p


def _prefill_case(shape, dtype, device, seed=1):
    hq, hkv, d, nb, bs, mb = shape
    rng = np.random.default_rng(seed)
    ct = min(128, bs * mb // 4)
    n_seqs = 3
    kp, vp, bt = _pools(rng, shape, n_seqs, dtype, device)
    # (slot, pos0, valid): full tiles, a tile ending on a block edge, pad
    # rows, a tile starting mid-block, and one all-pad tile
    tiles = [(0, 0, ct), (0, ct, ct), (1, bs - 1, ct - 3),
             (2, 3 * bs + 1, ct // 2), (n_seqs, 0, 0)]
    last = {}
    for s, p0, v in tiles:
        if v:
            last[s] = max(last.get(s, 0), (p0 + v - 1) // bs)
    q = torch.tensor(rng.normal(size=(len(tiles) * ct, hq, d)), dtype=dtype, device=device)
    bt_k, bt_p = _tables(bt, last, device)
    meta = [torch.tensor(c, dtype=torch.int32, device=device) for c in zip(*tiles)]
    valid_rows = np.concatenate([np.arange(ct) < v for _, _, v in tiles])
    return (q, kp, vp, *meta), bt_k, bt_p, ct, valid_rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_decode_kernel_matches_plain(cuda, shape, dtype):
    args, bt_k, bt_p = _decode_case(SHAPES[shape], dtype, cuda)
    got = pa.paged_decode_attention(*args, bt_k)
    want = pa.paged_decode_attention_ref(*args, bt_p)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_prefill_kernel_matches_plain(cuda, shape, dtype):
    args, bt_k, bt_p, ct, valid_rows = _prefill_case(SHAPES[shape], dtype, cuda)
    got = pa.ragged_prefill_attention(*args, bt_k, ct)
    want = pa.ragged_prefill_attention_ref(*args, bt_p, ct)
    torch.cuda.synchronize()
    assert pa.ragged_prefill_attention.launches == 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    # pad rows and the all-pad tile are exact zeros, as in the Pallas kernel
    assert not got[torch.from_numpy(~valid_rows).to(cuda)].any()


def test_kernels_reject_what_they_do_not_take(cuda):
    args, bt_k, _ = _decode_case(SHAPES["unit_layout"], torch.float32, cuda)
    q = args[0]
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.half(), *args[1:], bt_k)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                                  *args[1:], bt_k)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, *args[1:3], args[3][:-1], args[4], bt_k)
    assert pa.paged_decode_attention.launches == 0


# ------------------------------------------------------- flash attention
# (B, Sq, Skv, Hq, Hkv, D): lengths off the 64-row tile, GQA rep 4 and 1,
# both head dims, queries shorter than keys (causal: top-left, as Pallas)
FLASH_SHAPES = {
    "ragged_gqa4_d128": (2, 100, 100, 8, 2, 128),
    "mha_d64": (1, 130, 130, 4, 4, 64),
    "short_q_d128": (1, 64, 192, 4, 2, 128),
    "one_tile_d64": (2, 17, 17, 4, 1, 64),
}


def _flash_case(shape, dtype, device, seed=0, strided=False):
    b, sq, skv, hq, hkv, d = shape
    rng = np.random.default_rng(seed)

    def make(s, h):
        x = torch.tensor(rng.normal(size=(b, s, h, d)), dtype=dtype, device=device)
        # strided: the same values in a [B, H, S, D] buffer, viewed as [B, S, H, D]
        return x.transpose(1, 2).contiguous().transpose(1, 2) if strided else x

    return make(sq, hq), make(skv, hkv), make(skv, hkv), make(sq, hq)


@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
def test_flash_kernels_match_plain(cuda, shape, dtype, causal, strided):
    q, k, v, do = _flash_case(FLASH_SHAPES[shape], dtype, cuda, strided=strided)
    fa.reset_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal)
    grads_ref = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dkdv.launches,
            fa.flash_attention_dq.launches) == (1, 1, 1)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=name)
    if dtype == torch.bfloat16:
        # elementwise 2e-2 is near the outputs' own size; hold each output to
        # the relative Frobenius limit of chip_smoke.py's bf16 flash check
        for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_ref, *grads_ref)):
            rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
            assert rel <= FLASH_BF16_REL_FRO, (name, rel)


def test_flash_autograd_matches_eager_attention(cuda):
    """The autograd function (three kernels) against autograd through the
    fp32 eager oracle, at Sq == Skv where both mask alike."""
    from deepspeed_tpu_torch.ops.attention import eager_attention

    q, k, v, do = _flash_case((2, 96, 96, 8, 2, 128), torch.float32, cuda)
    outs, grads = [], []
    for fn in (fa.flash_attention, eager_attention):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        o = fn(qq, kk, vv, True)
        (o * do).sum().backward()
        outs.append(o)
        grads.append((qq.grad, kk.grad, vv.grad))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-4)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _flash_case((1, 64, 64, 4, 2, 96), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v, do = _flash_case((1, 64, 64, 4, 2, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    assert fa.flash_attention_fwd.launches == 0
