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
# a GQA rep=4 case, the tiny engine of tests/test_torch_ragged.py, Llama-3-8B;
# then GQA rep 1 and 8 and the head dims besides 64 and 128 that the
# reference's kernels take (16, 80, 96, 256, and above 256 the wide kernels'
# 264, 384 and 512, and above 1024, their rows in a global workspace, 1032
# and 2048)
SHAPES = {
    "unit_layout": (4, 2, 16, 16, 8, 4),
    "gqa4_d128": (8, 2, 128, 64, 32, 8),
    "tiny_engine": (4, 2, 8, 49, 4, 16),
    "llama3_8b": (32, 8, 128, 577, 32, 18),
    "rep1_d64": (4, 4, 64, 64, 16, 8),
    "rep8_d80": (16, 2, 80, 64, 16, 8),
    "gqa4_d16": (8, 2, 16, 64, 16, 8),
    "gqa4_d96": (8, 2, 96, 64, 16, 8),
    "gqa4_d256": (8, 2, 256, 64, 16, 8),
    "gqa4_d264": (8, 2, 264, 64, 16, 8),
    "rep8_d384": (16, 2, 384, 64, 16, 8),
    "gqa4_d512": (8, 2, 512, 64, 16, 8),
    "gqa4_d1032": (8, 2, 1032, 64, 16, 8),
    "rep8_d2048": (16, 2, 2048, 64, 16, 8),
}
# fp32 kernel vs fp32 plain: summation order only; bf16: both round the
# output to bf16 (one ulp at |x| ~ 1 is 2**-7) from the same bf16 inputs
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 flash and prefill outputs: ||got - want||_F / ||want||_F, the limit of
# chip_smoke.py's bf16 flash and prefill checks (between a correct kernel's
# bf16 rounding and a softmax scale one bf16 ulp off)
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


def _decode_case(shape, dtype, device, seed=0, tokens=15):
    hq, hkv, d, nb, bs, mb = shape
    rng = np.random.default_rng(seed)
    n_seqs = 6
    kp, vp, bt = _pools(rng, shape, n_seqs, dtype, device)
    ctx = mb * bs
    # the whole table, the first position, block edges, random positions,
    # then padding tokens (3 of 15; none in a case of a few tokens)
    n_pad = min(3, tokens // 5)
    pos = [ctx - 1, 0, bs - 1, bs, 2 * bs - 1]
    pos = (pos + list(rng.integers(0, ctx, max(0, tokens - n_pad - len(pos)))))
    pos = pos[:tokens - n_pad]
    slots = [i % n_seqs for i in range(len(pos))]
    slots += [n_seqs] * n_pad
    pos += [0] * n_pad
    last = {}
    for s, p in zip(slots, pos):
        if s < n_seqs:
            last[s] = max(last.get(s, 0), p // bs)
    q = torch.tensor(rng.normal(size=(len(pos), hq, d)), dtype=dtype, device=device)
    bt_k, bt_p = _tables(bt, last, device)
    slots = torch.tensor(slots, dtype=torch.int32, device=device)
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    return (q, kp, vp, slots, pos), bt_k, bt_p


def _prefill_case(shape, dtype, device, seed=1, ct=None):
    hq, hkv, d, nb, bs, mb = shape
    rng = np.random.default_rng(seed)
    ct = ct or min(128, bs * mb // 4)
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


def _split_regime(shape, regime):
    """(tokens, the split count ``decode_splits`` gives them) for a regime of
    the decode kernel, reached through the sizes the split count comes from:
    15 tokens ("auto", whatever it picks); tokens x Hkv >= C SMs ("one": every
    output written directly); C SMs / 2 <= tokens x Hkv < C SMs ("two"); the
    most tokens, up to 15, at which each split holds one block of the table
    ("block": every split of a long context merged)."""
    hkv, mb = shape[1], shape[5]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = pa._DECODE_CTAS_PER_SM * sms
    tokens = {"auto": 15, "one": -(-ctas // hkv), "two": -(-ctas // (2 * hkv)),
              "block": max(t for t in range(1, 16)
                           if pa.decode_splits(t, hkv, mb, sms) == mb)}[regime]
    return tokens, pa.decode_splits(tokens, hkv, mb, sms)


# the decode kernel's split count: its own choice at 15 tokens, one split,
# two, and one block a split; contexts run from one key to the table's
# width. The forced regimes run on a workspace the caller owns, "auto" on
# buffers from the caching allocator.
@pytest.mark.parametrize("splits", ["auto", "one", "two", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_decode_kernel_matches_plain(cuda, shape, dtype, splits):
    hq, hkv, d, _, _, mb = SHAPES[shape]
    tokens, n = _split_regime(SHAPES[shape], splits)
    if splits != "auto":
        assert n == {"one": 1, "two": min(2, mb), "block": mb}[splits]
    workspace = None if splits == "auto" else pa.DecodeWorkspace(cuda, hq, hkv, d)
    args, bt_k, bt_p = _decode_case(SHAPES[shape], dtype, cuda, tokens=tokens)
    got = pa.paged_decode_attention(*args, bt_k, workspace=workspace)
    want = pa.paged_decode_attention_ref(*args, bt_p)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_prefill_kernel_matches_plain(cuda, shape, dtype):
    _check_prefill(*_prefill_case(SHAPES[shape], dtype, cuda))


def _check_prefill(args, bt_k, bt_p, ct, valid_rows):
    got = pa.ragged_prefill_attention(*args, bt_k, ct)
    want = pa.ragged_prefill_attention_ref(*args, bt_p, ct)
    torch.cuda.synchronize()
    assert pa.ragged_prefill_attention.launches == 1
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=TOL[got.dtype], rtol=TOL[got.dtype])
    else:  # the tensor-core kernel: relative Frobenius error, as the flash kernels
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rel <= FLASH_BF16_REL_FRO, rel
    # pad rows and the all-pad tile are exact zeros, as in the Pallas kernel
    assert not got[torch.from_numpy(~valid_rows).to(got.device)].any()


# the bf16 prefill kernel's edges: blocks of 8, 16 and 32 keys (a quarter,
# half and all of its 32-key step), tiles of 64-256 tokens, GQA rep 1, 4, 8
# and both head dims; each table has room for 2 CT tokens and 4 blocks more
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("ct", [64, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_prefill_kernel_edges(cuda, bs, ct, rep, d):
    mb = 2 * ct // bs + 4
    shape = (2 * rep, 2, d, 3 * mb + 1, bs, mb)
    _check_prefill(*_prefill_case(shape, torch.bfloat16, cuda, ct=ct))


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
    with pytest.raises(ValueError, match="multiple"):
        pa.DecodeWorkspace(cuda, 6, 4, 16)
    # a workspace sized for the unit layout is too small for the 8B's call
    small = pa.DecodeWorkspace(cuda, *SHAPES["unit_layout"][:3])
    big, big_bt, _ = _decode_case(SHAPES["llama3_8b"], torch.float32, cuda)
    with pytest.raises(ValueError, match="does not fit"):
        pa.paged_decode_attention(*big, big_bt, workspace=small)
    assert pa.paged_decode_attention.launches == 0


@pytest.mark.parametrize("workspace", ["owned", "per_call"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_paged_decode_is_captured_by_a_cuda_graph(cuda, dtype, workspace):
    """The decode call reads nothing back from the card: a CUDA graph
    captures one call whose contexts are split and merged, on a workspace
    the caller owns or on buffers the call takes from the caching allocator.
    A larger call (more partials) then runs on the same workspace, and
    replaying the graph on new inputs still equals a direct call."""
    shape = SHAPES["llama3_8b"]
    ws = pa.DecodeWorkspace(cuda, *shape[:3]) if workspace == "owned" else None
    tokens, splits = _split_regime(shape, "block")  # one block a split
    args, bt_k, _ = _decode_case(shape, dtype, cuda, tokens=tokens)
    q = args[0]
    pa.paged_decode_attention(*args, bt_k, workspace=ws)  # loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pa.paged_decode_attention(*args, bt_k, workspace=ws)
    big_tokens, big_splits = _split_regime(shape, "auto")
    assert big_tokens * big_splits > tokens * splits
    big, big_bt, big_bt_p = _decode_case(shape, dtype, cuda, seed=1, tokens=big_tokens)
    got_big = pa.paged_decode_attention(*big, big_bt, workspace=ws)
    q.copy_(torch.randn_like(q))
    graph.replay()
    direct = pa.paged_decode_attention(*args, bt_k, workspace=ws)
    want_big = pa.paged_decode_attention_ref(*big, big_bt_p)
    torch.cuda.synchronize()
    assert torch.equal(captured, direct)
    torch.testing.assert_close(got_big.float(), want_big.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# ------------------------------------------------------- flash attention
# (B, Sq, Skv, Hq, Hkv, D): lengths off the 64-row tile, GQA rep 4 and 1,
# both head dims, queries shorter than keys and longer than keys (causal:
# top-left, as Pallas), and a sequence off the 128-row q tile that runs
# the forward's and dQ's 64-key rings through many phases at rep 8
FLASH_SHAPES = {
    "ragged_gqa4_d128": (2, 100, 100, 8, 2, 128),
    "mha_d64": (1, 130, 130, 4, 4, 64),
    "short_q_d128": (1, 64, 192, 4, 2, 128),
    "one_tile_d64": (2, 17, 17, 4, 1, 64),
    "gqa8_d128": (1, 300, 300, 16, 2, 128),
    "long_q_d128": (2, 250, 90, 8, 2, 128),
    "rep8_s1000_d128": (1, 1000, 1000, 16, 2, 128),
    # head dims the CUDA-core kernels serve in both dtypes, padded to 64, 128
    # and 256 (at 256 the backward loops over 32-row tiles)
    "gqa4_d16": (2, 100, 100, 8, 2, 16),
    "mha_d80": (1, 130, 130, 4, 4, 80),
    "short_q_d96": (1, 64, 192, 4, 2, 96),
    "gqa8_d256": (1, 300, 300, 16, 2, 256),
    # the wide kernels (head dims above 256, streamed in 256-wide chunks;
    # above 1024 their rows in a global workspace)
    "gqa4_d264": (2, 100, 100, 8, 2, 264),
    "short_q_d384": (1, 64, 192, 4, 2, 384),
    "long_q_d512": (1, 130, 70, 8, 2, 512),
    "gqa4_d1032": (1, 100, 100, 8, 2, 1032),
    "short_q_d2048": (1, 64, 192, 4, 2, 2048),
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


@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["fwd", "dkdv", "dq", "decode"])
def test_flash_kernels_are_bit_identical_across_launches(cuda, kernel, dtype, strided):
    """Two launches on the same inputs give the same bits: the flash kernels
    use no atomics (S = 300 lies off their 128-row tiles), and the decode
    kernel merges its splits (here one block each) in a fixed order; its
    strided case reads a column slice of a wider table."""
    if kernel == "decode":
        tokens, _ = _split_regime(SHAPES["llama3_8b"], "block")
        args, bt_k, _ = _decode_case(SHAPES["llama3_8b"], dtype, cuda, tokens=tokens)
        if strided:
            wide = torch.zeros(bt_k.shape[0], bt_k.shape[1] + 5, dtype=bt_k.dtype,
                               device=cuda)
            wide[:, :bt_k.shape[1]] = bt_k
            bt_k = wide[:, :bt_k.shape[1]]
        fn = lambda: (pa.paged_decode_attention(*args, bt_k),)  # noqa: E731
        counter = pa.paged_decode_attention
    else:
        q, k, v, do = _flash_case((2, 300, 300, 8, 2, 128), dtype, cuda, strided=strided)
        o, lse = fa.flash_attention_fwd_ref(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        fn = {"fwd": lambda: fa.flash_attention_fwd(q, k, v, True),
              "dkdv": lambda: fa.flash_attention_dkdv(q, k, v, do, lse, delta, True),
              "dq": lambda: (fa.flash_attention_dq(q, k, v, do, lse, delta, True),)}[kernel]
        counter = getattr(fa, f"flash_attention_{kernel}")
    first, second = fn(), fn()
    torch.cuda.synchronize()
    assert counter.launches == 2
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


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
    """Head dims off the 8-grid raise before any launch; 96 and 1032, which
    the reference takes, are computed."""
    q, k, v, do = _flash_case((1, 64, 64, 4, 2, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, k, v)
    assert fa.flash_attention_fwd.launches == 0
    for d in (96, 1032):
        q, k, v, do = _flash_case((1, 64, 64, 4, 2, d), torch.float32, cuda)
        o, _ = fa.flash_attention_fwd(q, k, v)
        torch.testing.assert_close(o, fa.flash_attention_fwd_ref(q, k, v)[0], atol=1e-4,
                                   rtol=1e-4)
    fa.reset_counts()
    q, k, v, do = _flash_case((1, 64, 64, 4, 2, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    assert fa.flash_attention_fwd.launches == 0


def test_tiny_llama_trains_on_the_kernels(cuda):
    """LlamaConfig.tiny() (head dim 16) trains on the card through the flash
    kernels, never the plain versions, and its loss falls on a repeated
    batch."""
    from functools import partial

    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    cfg = llama.LlamaConfig.tiny()
    eng, _, _, _ = engine_mod.initialize(
        model=partial(llama.build, cfg), seed=0,
        config={"train_micro_batch_size_per_device": 2, "steps_per_print": 0,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}})
    batch = {"input_ids": np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64),
                                                            dtype=np.int32)}
    losses = [float(eng.train_batch(batch)) for _ in range(6)]
    assert fa.flash_attention_fwd.launches > 0 and fa.flash_attention_dq.launches > 0
    assert fa.flash_attention_fwd_ref.calls == fa.flash_attention_bwd_ref.calls == 0
    assert losses[-1] < losses[0], losses


# ------------------------------------------- the engine's CUDA graphs
# the tiny engine of tests/test_torch_ragged.py (block size 4: tables grow
# every 4 tokens, so replays meet rows synced since their capture)
ENGINE_CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
                  num_heads=4, num_kv_heads=2, max_seq_len=128)
ENGINE_RCFG = dict(max_tokens_per_step=16, max_seqs=3, block_size=4, num_blocks=49,
                   max_blocks_per_seq=16)
GRAPH_MODES = {"plain": {}, "tiled": {"prefill_tile": 8}, "run_ahead": {"decode_run_ahead": 4},
               "fused": {"fused_chunk": 4, "pipeline_depth": 3},
               "fused_tiled": {"fused_chunk": 4, "pipeline_depth": 3, "prefill_tile": 8},
               "sched": {"sched_steps": 8},
               "spec": {"sched_steps": 8, "spec_draft": 4},
               "fused_spec": {"fused_chunk": 4, "pipeline_depth": 3, "sched_steps": 8,
                              "spec_draft": 4}}
# the program kinds each mode captures: exactly, or (scheduler modes) at
# least the scheduler's and at most these
GRAPH_KINDS = {"run_ahead": {"step", "chunk"}, "fused": {"fused"}, "fused_tiled": {"fused"},
               "sched": {"step", "sched"}, "spec": {"step", "sched"},
               "fused_spec": {"fused", "sched"}}


def _graph_engine(mode, dtype, graphs: bool):
    """A device-resident engine on the card; ``graphs=False`` runs every
    program eagerly (its program cache treated as off the card)."""
    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                RaggedConfig(**ENGINE_RCFG, **GRAPH_MODES[mode]),
                                dtype=dtype, seed=0)
    if not graphs:
        eng.programs.on_card = False
    return eng


def _graph_run(mode, dtype, graphs: bool, max_new=24):
    """Tokens, KV pool, launch counts and engine of 7 requests (more than
    the slots) through ``_graph_engine``."""
    eng = _graph_engine(mode, dtype, graphs)
    rng = np.random.default_rng(11)
    pa.reset_counts()
    for i, n in enumerate((3, 4, 5, 8, 9, 13, 17)):
        eng.put(f"r{i}", rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist(),
                max_new_tokens=max_new)
    out = eng.generate_all()
    torch.cuda.synchronize()
    launches = (pa.paged_decode_attention.launches, pa.ragged_prefill_attention.launches)
    return out, eng.cache, launches, eng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graphs_replay_bit_identical_to_eager(cuda, mode, dtype):
    """The captured steps (and, with run-ahead, chunks; with fused chunks,
    every fused program, mixed ones too; with the scheduler, its loop
    programs, their iterations under conditional nodes) replay bit for bit
    what the same programs compute eagerly on the same inputs: the same
    tokens and the same KV pool (past scratch block 0 with the scheduler,
    whose retired and draft lanes all write key 0 of block 0 at once)."""
    out_g, cache_g, _, eng = _graph_run(mode, dtype, graphs=True)
    out_e, cache_e, _, ref = _graph_run(mode, dtype, graphs=False)
    assert eng.programs.replays > 0 and ref.programs.replays == 0
    kinds = {key[0] for key in eng.programs._graphs}
    if "sched_steps" in GRAPH_MODES[mode]:
        assert "sched" in kinds and kinds <= GRAPH_KINDS[mode]
        blocks = slice(1, None)
        # the graphs' iterations and drafts are the eager loop's; greedy
        # streams of the tiny random model repeat, so drafts are accepted
        assert ((eng.sched_iterations, eng.spec_proposed, eng.spec_accepted)
                == (ref.sched_iterations, ref.spec_proposed, ref.spec_accepted))
        assert eng.spec_accepted > 0 or "spec_draft" not in GRAPH_MODES[mode]
    else:
        assert kinds == GRAPH_KINDS.get(mode, {"step"})
        blocks = slice(None)
    assert out_g == out_e
    assert torch.equal(cache_g["k"][:, blocks], cache_e["k"][:, blocks])
    assert torch.equal(cache_g["v"][:, blocks], cache_e["v"][:, blocks])
    assert eng.allocator.free_blocks == ENGINE_RCFG["num_blocks"] - 1


def test_replay_after_dirty_row_sync_sees_new_table(cuda):
    """Rows delta-uploaded into the device table after a graph was captured
    are read by its later replays: the engine syncs rows into the one
    tensor the graphs captured, and the tokens stay the eager run's."""
    eng = _graph_engine("plain", torch.float32, graphs=True)
    table = eng._bt_dev
    sync = eng._sync_bt
    replays_after_sync = []

    def spy():
        dirty = sync()
        if dirty and eng.programs.graphs:
            replays_after_sync.append(eng.programs.replays)
        return dirty

    eng._sync_bt = spy
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, ENGINE_CFG["vocab_size"], 5).tolist()
    eng.put("a", prompt, max_new_tokens=40)
    out = eng.generate_all()
    ref = _graph_engine("plain", torch.float32, graphs=False)
    ref.put("a", prompt, max_new_tokens=40)
    assert out == ref.generate_all()
    assert eng._bt_dev is table
    # the table grew (a dirty row) after capture, and graphs replayed after that
    assert replays_after_sync and eng.programs.replays > replays_after_sync[0]


def test_readback_after_next_dispatch_is_the_dispatchs_own(cuda):
    """With one request decoding alone every decode step replays one graph,
    whose static output the next replay overwrites before the previous
    step is reconciled: the tokens read back must still be each step's own
    (those of the eager run)."""
    out_g, _, _, eng = _graph_run("plain", torch.float32, graphs=True, max_new=40)
    out_e, _, _, _ = _graph_run("plain", torch.float32, graphs=False, max_new=40)
    assert eng.programs.replays >= 10
    assert out_g == out_e
    # consecutive tokens differ somewhere (a stale buffer would repeat them)
    assert any(len(set(v)) > 1 for v in out_g.values())


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_launch_counters_advance_per_replay(cuda, mode):
    """A graph's kernel launches are counted at every replay (not once, at
    capture): the counters read what the eager run counts."""
    _, _, launches_g, eng = _graph_run(mode, torch.float32, graphs=True)
    _, _, launches_e, _ = _graph_run(mode, torch.float32, graphs=False)
    assert eng.programs.replays > 0
    assert launches_g == launches_e
    assert pa.paged_decode_attention_ref.calls == pa.ragged_prefill_attention_ref.calls == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mixed_fused_program_replays_bit_identical(cuda, dtype):
    """chip_smoke.py's fused program check on a tiny model at the serving
    cell's engine sizes: one mixed fused program (two prefill tiles, a
    16-step decode scan with full, frozen and retired rows) captured and
    replayed gives the bits of its eager run (the live rows' tokens, the KV
    pool past scratch block 0, the slot rows but the scratch row), and
    writes the KV of exactly the rows and steps it schedules."""
    import chip_smoke
    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                RaggedConfig(**chip_smoke.ENGINE, **chip_smoke.FUSED),
                                dtype=dtype, seed=0)
    res = chip_smoke.fused_program_check(torch, np, eng)
    assert res["graph_replays"] == 1 and res["bit_identical"], res
    assert res["kv_rows_written_outside_schedule"] == res["kv_rows_missing"] == 0, res
    assert res["frozen_and_retired_rows_surface_minus_one"], res
    assert pa.paged_decode_attention_ref.calls == pa.ragged_prefill_attention_ref.calls == 0


@pytest.mark.parametrize("mode", ["fused", "fused_tiled", "fused_spec"])
def test_warmup_then_serving_only_replays(cuda, mode):
    """After warmup() every dispatch of a run replays a graph (no capture,
    no eager run), the decode kernel (and with tiles the prefill kernel)
    launches inside replays, and tokens and launch counts equal those of
    the same engine run eagerly."""
    eng = _graph_engine(mode, torch.float32, graphs=True)
    assert eng.warmup() > 0
    captures, eager = eng.programs.captures, eng.programs.eager_runs
    assert captures == eng.programs.graphs > 0
    rng = np.random.default_rng(11)
    prompts = {f"r{i}": rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist()
               for i, n in enumerate((3, 4, 5, 8, 9, 13, 17))}
    pa.reset_counts()
    replayed = list(eng.programs.replayed)
    for uid, p in prompts.items():
        eng.put(uid, p, max_new_tokens=24)
    out = eng.generate_all()
    torch.cuda.synchronize()
    launches = (pa.paged_decode_attention.launches, pa.ragged_prefill_attention.launches)
    assert (eng.programs.captures, eng.programs.eager_runs) == (captures, eager)
    assert eng.programs.replays == eng.dispatch_count
    in_replays = [a - b for a, b in zip(eng.programs.replayed, replayed)]
    assert in_replays[0] > 0 and (in_replays[1] > 0) == (mode == "fused_tiled")
    assert launches == tuple(in_replays[:2])
    out_e, _, launches_e, _ = _graph_run(mode, torch.float32, graphs=False)
    assert out == out_e and launches == launches_e


def test_sched_program_replays_bit_identical_and_exits_early(cuda):
    """chip_smoke.py's scheduler program check on a tiny model at the serving
    cell's engine sizes: one scheduler program (k = 16, 32 rows, EOS and
    budgets retiring rows at different steps) captured and replayed gives
    the bits of its eager run, the steps an eager probe predicts, as many
    iterations as its deepest row's steps, and the KV of exactly the
    positions it fed; a replay whose rows all retire by iteration 3 runs at
    most 3 iterations, one with every row retired at the start none."""
    import chip_smoke
    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                RaggedConfig(**chip_smoke.ENGINE, **chip_smoke.SCHED),
                                dtype=torch.bfloat16, seed=0)
    res = chip_smoke.sched_program_check(torch, np, eng)
    assert res["bit_identical"] and res["steps_as_probed"], res
    assert res["iterations"] == res["deepest_row_steps"], res
    assert res["kv_rows_written_outside_schedule"] == res["kv_rows_missing"] == 0, res
    assert res["full_iterations"] == [16] and max(res["early_exit_iterations"]) <= 3, res
    assert res["all_retired_iterations"] == [0], res
    assert pa.paged_decode_attention_ref.calls == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_paged_decode_on_a_verify_batch(cuda, dtype):
    """Kernel 4 on chip_smoke.py's speculative verify batch (32 sequences x 5
    consecutive positions, their K/V written first, so each lane reads the
    keys of the lanes before it) against its plain version."""
    import chip_smoke

    args = chip_smoke.verify_case(torch, np, dtype)
    workspace = pa.DecodeWorkspace("cuda", chip_smoke.HQ, chip_smoke.HKV, chip_smoke.D)
    got = pa.paged_decode_attention(*args, workspace=workspace)
    want = pa.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    assert ((got.float() - want.float()).abs() <= tol * (1 + want.float().abs())).all()
    assert pa.paged_decode_attention.launches == 1
