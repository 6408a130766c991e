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


def _graph_engine(mode, dtype, graphs: bool, quant: str = "off"):
    """A device-resident engine on the card; ``graphs=False`` runs every
    program eagerly (its program cache treated as off the card)."""
    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                RaggedConfig(**ENGINE_RCFG, **GRAPH_MODES[mode], quant=quant),
                                dtype=dtype, seed=0)
    if not graphs:
        eng.programs.on_card = False
    return eng


# seeded sampling mixed with greedy rows, one set of controls a request
SAMPLED = ({}, dict(temperature=0.9, seed=7), dict(temperature=0.7, top_k=5, seed=11), {},
           dict(temperature=1.1, top_p=0.8), dict(temperature=0.8, top_k=20, top_p=0.9, seed=3),
           dict(top_k=3))


def _graph_run(mode, dtype, graphs: bool, max_new=24, sampling=({},) * 7, quant="off"):
    """Tokens, KV pool, launch counts and engine of 7 requests (more than
    the slots) through ``_graph_engine``, each put with its ``sampling``
    controls."""
    eng = _graph_engine(mode, dtype, graphs, quant)
    rng = np.random.default_rng(11)
    pa.reset_counts()
    for i, (n, kw) in enumerate(zip((3, 4, 5, 8, 9, 13, 17), sampling)):
        eng.put(f"r{i}", rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist(),
                max_new_tokens=max_new, **kw)
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


# ----------------------------------------------- seeded sampling, dense engine
def test_threefry_on_the_card_is_bit_identical(cuda):
    """Keys, fold_in, the words and the uniforms on the card equal the CPU's
    (integer work, and an exact float step)."""
    from deepspeed_tpu_torch.utils import prng

    tiny = float(torch.finfo(torch.float32).tiny)
    for seed in (0, 7, 0x5A3D1E, 2**31 - 1):
        kc, kg = prng.prng_key(seed), prng.prng_key(seed, cuda)
        rows_c = prng.fold_in(kc, torch.arange(8))
        rows_g = prng.fold_in(kg, torch.arange(8, device=cuda))
        assert torch.equal(rows_g.cpu(), rows_c)
        assert torch.equal(prng.random_bits(rows_g, (97,)).cpu(), prng.random_bits(rows_c, (97,)))
        for shape in ((1,), (97,), (3, 11), (4, 128256)):
            assert torch.equal(prng.random_bits(kg, shape).cpu(), prng.random_bits(kc, shape))
            for lo in (0.0, tiny):
                assert torch.equal(prng.uniform(kg, shape, lo).cpu(), prng.uniform(kc, shape, lo))


@pytest.mark.parametrize("mode", ["plain", "run_ahead", "fused", "sched", "fused_spec"])
def test_sampled_graphs_replay_bit_identical_to_eager(cuda, mode):
    """Seeded requests mixed with greedy ones: the captured programs (each
    key carrying its batch's sampling flags) replay what the same programs
    compute eagerly, and the host-staged engine on the card draws the same
    streams."""
    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    out_g, _, _, eng = _graph_run(mode, torch.float32, graphs=True, sampling=SAMPLED)
    out_e, _, _, _ = _graph_run(mode, torch.float32, graphs=False, sampling=SAMPLED)
    assert eng.programs.replays > 0 and out_g == out_e
    assert any(key[-3] for key in eng.programs._graphs)  # a sampled program was captured
    host = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                 RaggedConfig(**ENGINE_RCFG, device_state=False),
                                 dtype=torch.float32, seed=0)
    rng = np.random.default_rng(11)
    for i, (n, kw) in enumerate(zip((3, 4, 5, 8, 9, 13, 17), SAMPLED)):
        host.put(f"r{i}", rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist(),
                 max_new_tokens=24, **kw)
    assert host.generate_all() == out_g


def test_sampled_warmup_then_serving_only_replays(cuda):
    """After ``warmup(sampled=True, has_tk=True, has_tp=True)`` a run of
    sampled, filtered requests captures nothing."""
    eng = _graph_engine("fused_spec", torch.float32, graphs=True)
    assert eng.warmup(sampled=True, has_tk=True, has_tp=True) > 0
    captures, eager = eng.programs.captures, eng.programs.eager_runs
    rng = np.random.default_rng(11)
    for i, n in enumerate((3, 4, 5, 8, 9, 13, 17)):
        eng.put(f"r{i}", rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist(),
                max_new_tokens=24, temperature=0.8, top_k=9, top_p=0.9, seed=i)
    eng.generate_all()
    torch.cuda.synchronize()
    assert (eng.programs.captures, eng.programs.eager_runs) == (captures, eager)
    assert eng.programs.replays == eng.dispatch_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dense_engine_graphs_match_eager(cuda, dtype):
    """The dense engine's captured prefill and decode step replay what they
    compute eagerly, greedy and sampled with every filter and the
    repetition penalty; a repeated key captures nothing."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models import llama

    eng = InferenceEngine(llama.build(llama.LlamaConfig.tiny()), dtype=dtype, seed=0)
    prompt = np.random.default_rng(2).integers(0, 256, (3, 9)).astype(np.int32)
    for kw in ({}, dict(temperature=0.8, seed=4, top_k=9, top_p=0.9, repetition_penalty=1.2)):
        graph = eng.generate(prompt, max_new_tokens=12, **kw)
        captures = eng.programs.captures
        again = eng.generate(prompt, max_new_tokens=12, **kw)
        assert eng.programs.captures == captures and np.array_equal(graph, again)
        eng.programs.on_card = False
        eager = eng.generate(prompt, max_new_tokens=12, **kw)
        eng.programs.on_card = True
        assert np.array_equal(graph, eager)
    assert eng.programs.captures == 4 and eng.programs.replays > 0


# ------------------------------ prefix splice, tier restore, handoff import
SHARED_PREFIX = [11, 7, 3, 5, 2, 13, 17, 19]  # two full blocks of 4
TRANSFER_MODES = {"fused": GRAPH_MODES["fused"], "fused_spec": GRAPH_MODES["fused_spec"]}


def _transfer_run(mode, graphs: bool, quant: str = "off"):
    """On the tiny engine with the prefix cache and tiers (a 13-block pool,
    a 4-block host arena): warmup() captures the programs first, then a
    prefix splice, a churn that demotes the prefix, a tier restore, and a
    handoff record (made by an eager prefill engine) imported, each served
    by programs captured before the scatter wrote the pool. Returns tokens,
    the pool, the engine and the tier counters."""
    import tempfile

    from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
    from deepspeed_tpu_torch.models import llama

    over = dict(ENGINE_RCFG, **TRANSFER_MODES[mode], enable_prefix_cache=True, num_blocks=13,
                kv_tier=True, kv_tier_host_blocks=4, quant=quant)
    with tempfile.TemporaryDirectory() as d:
        eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**ENGINE_CFG)),
                                    RaggedConfig(**over, kv_tier_dir=d), dtype=torch.float32,
                                    seed=0)
        if not graphs:
            eng.programs.on_card = False
        eng.warmup()
        eng.warmup(sampled=True, has_tk=True)
        pre = RaggedInferenceEngine(eng.spec, RaggedConfig(**ENGINE_RCFG, quant=quant),
                                    dtype=torch.float32, params=eng.params)
        pre.programs.on_card = False
        out = {}
        for rnd in range(2):
            eng.put(f"warm{rnd}", SHARED_PREFIX + [23, 29, 31], max_new_tokens=6)
            out.update(eng.generate_all())
            eng.put(f"g{rnd}", SHARED_PREFIX + [37, 41], max_new_tokens=8)
            eng.put(f"s{rnd}", SHARED_PREFIX + [37, 41], max_new_tokens=8, temperature=0.9,
                    top_k=20, seed=123)
            out.update(eng.generate_all())
            for i in range(6):  # churn: the prefix demotes
                eng.put(f"c{rnd}{i}", [(50 + i * 7 + j) % 97 for j in range(9)],
                        max_new_tokens=4)
                out.update(eng.generate_all())
        pre.put("h", SHARED_PREFIX + [43, 47, 53], max_new_tokens=8, handoff=True,
                temperature=0.9, top_k=20, seed=5)
        pre.generate_all()
        assert eng.import_handoff(pre.export_handoff("h"))
        out.update(eng.generate_all())
        stats = eng.kv_tier_stats()
        eng._kvtier.close()
    torch.cuda.synchronize()
    return out, eng.cache, eng, stats


@pytest.mark.parametrize("mode", list(TRANSFER_MODES))
def test_transfers_write_the_pool_the_graphs_replay(cuda, mode):
    """A prefix splice, a tier restore (blocks scattered back into the pool)
    and a handoff import (blocks scattered in) served by fused and scheduler
    graphs captured before any of them: the replays give the tokens and the
    pool of the same engine run eagerly, so the scatter wrote the pool
    tensors the graphs hold, in place."""
    out_g, cache_g, eng, stats = _transfer_run(mode, graphs=True)
    out_e, cache_e, ref, _ = _transfer_run(mode, graphs=False)
    assert eng.programs.replays > 0 and eng.prefix_hits >= 4
    assert stats["demotions"] > 0 and stats["promotions"] > 0 and eng.kv_blocks_imported > 0
    assert out_g == out_e and len(out_g["h"]) == 8
    blocks = slice(1, None)  # scratch block 0: the scheduler's pad lanes write it at once
    assert torch.equal(cache_g["k"][:, blocks], cache_e["k"][:, blocks])
    assert torch.equal(cache_g["v"][:, blocks], cache_e["v"][:, blocks])


def test_gather_scatter_leave_decode_workspace(cuda):
    """Block gathers and scatters move ``k`` and ``v`` only, in place: the
    cache keeps its pool tensors and its decode workspace, whose buffers
    they do not touch."""
    eng = _graph_engine("fused", torch.bfloat16, graphs=True)
    ws = eng.cache["decode_workspace"]
    ptrs = (eng.cache["k"].data_ptr(), eng.cache["v"].data_ptr(), ws.part.data_ptr(),
            ws.counters.data_ptr())
    eng.put("r", list(range(1, 12)), max_new_tokens=6)
    eng.generate_all()
    torch.cuda.synchronize()
    part, counters = ws.part.clone(), ws.counters.clone()
    payload = eng._gather_blocks([1, 2, 3])
    assert set(payload) == {"k", "v"} and payload["k"].device.type == "cpu"
    eng._scatter_blocks([4, 5, 6], payload)
    torch.cuda.synchronize()
    assert eng.cache["decode_workspace"] is ws
    assert (eng.cache["k"].data_ptr(), eng.cache["v"].data_ptr(), ws.part.data_ptr(),
            ws.counters.data_ptr()) == ptrs
    # the partials are scratch (NaN where no call wrote): compared as bits
    assert torch.equal(ws.part.view(torch.int32), part.view(torch.int32))
    assert torch.equal(ws.counters, counters)
    assert torch.equal(eng.cache["k"][:, 4:7], eng.cache["k"][:, 1:4])
    assert torch.equal(eng.cache["v"][:, 4:7], eng.cache["v"][:, 1:4])


@pytest.mark.parametrize("pos0", [32, 64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_prefill_kernel_on_a_tail_after_a_prefix_hit(cuda, dtype, pos0):
    """Kernel 5 at Llama-3-8B's shapes on the chunk a prefix hit of pos0 /
    32 blocks leaves: tiles of 128 that start at a block edge but not at a
    tile edge (a full tile, a partial last one, another sequence's tail
    starting at 480), within chip_smoke.py's limits."""
    shape = SHAPES["llama3_8b"]
    hq, hkv, d, nb, bs, mb = shape
    ct = 128
    rng = np.random.default_rng(pos0)
    kp, vp, bt = _pools(rng, shape, 3, dtype, cuda)
    tiles = [(0, pos0, ct), (0, pos0 + ct, ct - 37), (1, 480, 32), (3, 0, 0)]
    last = {}
    for s, p0, v in tiles:
        if v:
            last[s] = max(last.get(s, 0), (p0 + v - 1) // bs)
    q = torch.tensor(rng.normal(size=(len(tiles) * ct, hq, d)), dtype=dtype, device=cuda)
    bt_k, bt_p = _tables(bt, last, cuda)
    meta = [torch.tensor(c, dtype=torch.int32, device=cuda) for c in zip(*tiles)]
    valid_rows = np.concatenate([np.arange(ct) < v for _, _, v in tiles])
    _check_prefill((q, kp, vp, *meta), bt_k, bt_p, ct, valid_rows)


# ---------------------------------------------------------------- low-bit
def _codec_rows():
    """KV rows at Llama-3-8B's head shapes with a zero row, a row whose fp16
    scale rounds to 0 and saturating values (tests/test_torch_kvquant.py
    holds the CPU's bytes to the JAX package's)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(256, 8, 128)) * rng.uniform(1e-3, 30, size=(256, 8, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1, 0] = 0.0
    x[1, 0, :6] = [1e-9, 0, -1e-9, 0, 3e-7, 1e-12]
    x[2] = 1e4
    return torch.from_numpy(x)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(-1).view(torch.uint8)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_kv_codec_on_the_card_is_bit_identical(cuda, codec):
    from deepspeed_tpu_torch.inference import kvquant

    x = _codec_rows()
    c = kvquant.get_codec(codec)
    qc, sc = kvquant.quantize_kv_rows(x.to(cuda), c)
    qh, sh = kvquant.quantize_kv_rows(x, c)
    assert qc.dtype == qh.dtype == c.storage
    assert torch.equal(_bits(sc), _bits(sh))
    diff = (_bits(qc) != _bits(qh)).nonzero()[:8, 0].tolist()
    assert not diff, (diff, _bits(qc)[diff].tolist(), _bits(qh)[diff].tolist())
    # fp8's 0 / 0 cells dequantize to NaN, whose bits the two devices' products
    # need not share: compared as values
    torch.testing.assert_close(kvquant.dequantize_kv_rows(qc, sc).cpu(),
                               kvquant.dequantize_kv_rows(qh, sh), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_on_the_card_is_bit_identical(cuda, bits):
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import quantizer

    cfg = llama.LlamaConfig(**ENGINE_CFG)
    host = llama.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    host["layers"]["wq"][0, 0, :] = 0.0       # a zero block
    host["layers"]["wq"][1, 0, :] = 1e-30     # a block under the 1e-12 floor
    card = {k: (v.to(cuda) if not isinstance(v, dict) else {n: w.to(cuda) for n, w in v.items()})
            for k, v in host.items()}
    want = quantizer.quantize_params(host, bits, block=32)
    got = quantizer.quantize_params(card, bits, block=32)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        g, w = got["layers"][name], want["layers"][name]
        assert torch.equal(_bits(g.values), _bits(w.values))
        assert torch.equal(_bits(g.scales), _bits(w.scales))
        assert torch.equal(_bits(quantizer.maybe_dequantize(g[1], torch.bfloat16)),
                           _bits(quantizer.maybe_dequantize(w[1], torch.bfloat16)))
    assert torch.equal(_bits(got["lm_head"].values), _bits(want["lm_head"].values))
    assert got["embed"].data_ptr() == card["embed"].data_ptr()  # kept dense


QUANT_GRAPH_MODES = ("plain", "fused", "fused_tiled", "sched", "fused_spec")


@pytest.mark.parametrize("quant", ["int8", "fp8", "woq8", "int8+woq4"])
@pytest.mark.parametrize("mode", QUANT_GRAPH_MODES)
def test_quantized_graphs_replay_bit_identical_to_eager(cuda, mode, quant):
    """With a low-bit pool (written in place by the captured programs) or
    low-bit weights, the replays give the eager run's tokens and pool;
    a quantized pool runs the quantized plain path (counted per replay) and
    no paged kernel, a woq-only engine the paged kernels."""
    out_g, cache_g, launches, eng = _graph_run(mode, torch.bfloat16, graphs=True, quant=quant)
    quantized = pa.quantized_decode_attention.calls + pa.quantized_prefill_attention.calls
    out_e, cache_e, _, ref = _graph_run(mode, torch.bfloat16, graphs=False, quant=quant)
    assert eng.programs.replays > 0 and out_g == out_e
    blocks = slice(1, None) if "sched_steps" in GRAPH_MODES[mode] else slice(None)
    if quant.startswith("woq"):
        assert launches[0] > 0 and quantized == 0
        assert launches[1] > 0 or "prefill_tile" not in GRAPH_MODES[mode]
        for name in ("k", "v"):
            assert torch.equal(cache_g[name][:, blocks], cache_e[name][:, blocks])
    else:
        assert launches == (0, 0) and quantized > 0
        for name in ("k", "v"):
            for a, b in ((cache_g[name].q, cache_e[name].q), (cache_g[name].s, cache_e[name].s)):
                assert torch.equal(_bits(a[:, blocks]), _bits(b[:, blocks]))
    assert eng.allocator.free_blocks == ENGINE_RCFG["num_blocks"] - 1


@pytest.mark.parametrize("mode", list(TRANSFER_MODES))
def test_quantized_transfers_write_the_pool_the_graphs_replay(cuda, mode):
    """``test_transfers_write_the_pool_the_graphs_replay`` on an int8 pool:
    splices, tier restores and a handoff import write ``q`` and ``s`` in
    place, where the graphs captured before them read."""
    out_g, cache_g, eng, stats = _transfer_run(mode, graphs=True, quant="int8")
    out_e, cache_e, _, _ = _transfer_run(mode, graphs=False, quant="int8")
    assert eng.programs.replays > 0 and eng.prefix_hits >= 4
    assert stats["demotions"] > 0 and stats["promotions"] > 0 and eng.kv_blocks_imported > 0
    assert stats["codec"] == "int8" and out_g == out_e and len(out_g["h"]) == 8
    for name in ("k", "v"):
        assert torch.equal(cache_g[name].q[:, 1:], cache_e[name].q[:, 1:])
        assert torch.equal(cache_g[name].s[:, 1:], cache_e[name].s[:, 1:])


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_gather_scatter_in_place(cuda, quant):
    """Block gathers and scatters of a quantized pool move ``q`` and ``s``
    in place (the graphs hold their pointers); the pool carries no decode
    workspace (no paged kernel reads it) and its tensors stay the same."""
    eng = _graph_engine("fused", torch.bfloat16, graphs=True, quant=quant)
    assert set(eng.cache) == {"k", "v"}
    ptrs = [t.data_ptr() for n in ("k", "v") for t in (eng.cache[n].q, eng.cache[n].s)]
    eng.put("r", list(range(1, 12)), max_new_tokens=6)
    eng.generate_all()
    torch.cuda.synchronize()
    payload = eng._gather_blocks([1, 2, 3])
    assert payload["k"].q.device.type == "cpu" and payload["k"].codec == quant
    eng._scatter_blocks([4, 5, 6], payload)
    torch.cuda.synchronize()
    assert [t.data_ptr() for n in ("k", "v") for t in (eng.cache[n].q, eng.cache[n].s)] == ptrs
    for name in ("k", "v"):
        pool = eng.cache[name]
        assert torch.equal(_bits(pool.q[:, 4:7]), _bits(pool.q[:, 1:4]))
        assert torch.equal(pool.s[:, 4:7], pool.s[:, 1:4])


# ------------------------------------------------ serving-tier contracts
def _graph_pointers(eng) -> list:
    """The data pointers of every tensor a captured graph reads or writes
    in place: the pool, the slot rows, the block table, the slot tokens,
    the staging buffers and the draft history."""
    from deepspeed_tpu_torch.inference.kvquant import kv_leaves

    ts = [x for name in ("k", "v") for x in kv_leaves(eng.cache[name])]
    ts += [*eng._dev_state, eng._bt_dev, eng._slot_toks, *(e[1] for e in eng._staging.values())]
    if eng._hist_dev is not None:
        ts.append(eng._hist_dev)
    return [t.data_ptr() for t in ts]


def _put_seven(eng, max_new=24):
    rng = np.random.default_rng(11)
    for i, n in enumerate((3, 4, 5, 8, 9, 13, 17)):
        eng.put(f"r{i}", rng.integers(0, ENGINE_CFG["vocab_size"], n).tolist(),
                max_new_tokens=max_new)


@pytest.mark.parametrize("mode", ["fused", "fused_spec"])
def test_reset_state_in_place_then_replay(cuda, mode):
    """``reset_state()`` in the middle of a run keeps every graph-held
    tensor where it is, and the warmed graphs then replay the cold
    engine's tokens, with nothing captured anew."""
    eng = _graph_engine(mode, torch.float32, graphs=True)
    eng.warmup()
    _put_seven(eng)
    for _ in range(6):
        eng.step()
    before = _graph_pointers(eng)
    captures = eng.programs.captures
    assert eng.reset_state() > 0
    torch.cuda.synchronize()
    assert _graph_pointers(eng) == before
    assert not any(x.any() for x in (eng.cache["k"], eng.cache["v"], eng._bt_dev))
    _put_seven(eng)
    out = eng.generate_all()
    torch.cuda.synchronize()
    cold, _, _, _ = _graph_run(mode, torch.float32, graphs=False)
    assert out == cold
    assert eng.programs.captures == captures and eng.programs.replays > 0
    assert set(before) <= set(_graph_pointers(eng))


def test_recovery_with_fused_chunks_in_flight(cuda):
    """Dispatch faults while up to three fused chunks are in flight on the
    card: recovery rewrites the graph-held rows in place, in stream order
    after the chunks already launched, and the replayed run gives the
    fault-free eager tokens."""
    from deepspeed_tpu_torch.serving import faults

    eng = _graph_engine("fused", torch.float32, graphs=True)
    eng.cfg.degrade_after = 0
    eng.cfg.retry_backoff_s = 0.0
    eng.cfg.dispatch_retries = 4
    eng.warmup()
    before = _graph_pointers(eng)
    inflight = []
    orig = eng._recover_device_path

    def spy():
        inflight.append(len(eng._inflight_chunks))
        orig()

    eng._recover_device_path = spy
    inj = faults.get_fault_injector()
    inj.configure([{"point": faults.POINT_DISPATCH, "kind": "raise", "after": 6},
                   {"point": faults.POINT_READBACK, "kind": "hang", "after": 9, "delay_s": 0.0},
                   {"point": faults.POINT_DISPATCH, "kind": "raise", "after": 14, "times": 2}])
    try:
        _put_seven(eng)
        out = eng.generate_all()
        torch.cuda.synchronize()
    finally:
        inj.reset()
    ref, _, _, _ = _graph_run("fused", torch.float32, graphs=False)
    assert out == ref
    assert eng.step_failures == 4 and max(inflight) >= 2
    assert _graph_pointers(eng)[:len(before)] == before


class _SyncCounter:
    """Counts ``torch.cuda.synchronize`` and CUDA event waits while on."""

    def __init__(self, monkeypatch):
        self.syncs = self.waits = 0
        sync, wait = torch.cuda.synchronize, torch.cuda.Event.synchronize

        def counted_sync(*a, **k):
            self.syncs += 1
            return sync(*a, **k)

        def counted_wait(ev):
            self.waits += 1
            return wait(ev)

        monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
        monkeypatch.setattr(torch.cuda.Event, "synchronize", counted_wait)


def test_telemetry_adds_no_synchronisation(cuda, monkeypatch):
    """The same warmed run with telemetry and tracing off and on: the same
    dispatches, replays, readbacks (event waits) and synchronize calls."""
    from deepspeed_tpu_torch import telemetry

    counts = []
    try:
        for on in (False, True):
            telemetry.TELEMETRY.reset()
            if on:
                telemetry.configure(enabled=True, tracing=True, slo=True)
            eng = _graph_engine("fused", torch.float32, graphs=True)
            eng.warmup()
            counter = _SyncCounter(monkeypatch)
            _put_seven(eng)
            out = eng.generate_all()
            counts.append((out, eng.dispatch_count, eng.programs.replays, counter.waits,
                           counter.syncs))
            monkeypatch.undo()
    finally:
        telemetry.TELEMETRY.reset()
    assert counts[0] == counts[1]
    assert counts[0][3] == counts[0][1]  # one readback wait a dispatch
