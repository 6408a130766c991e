"""The port's plain paged-attention versions against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/unit/test_paged_attention.py
runs them), plus the CPU routing of the port's dispatchers.

Inputs are made with numpy from a seed and handed to both packages; fp32,
atol = rtol = 2e-5 (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jax_attention
from deepspeed_tpu.ops.pallas import paged_attention as jax_pallas
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)


def _pools(rng, hkv, d, nb, bs):
    kp = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    return kp, vp


def _unit_table():
    # the table of tests/unit/test_paged_attention.py (row 2 = padding row)
    bt = np.zeros((3, 4), np.int32)
    bt[0] = [3, 5, 7, 11]
    bt[1] = [2, 9, 1, 0]
    return bt


def _gqa_table(rng, nb, mb):
    bt = np.zeros((3, mb), np.int32)
    bt[:2] = rng.permutation(np.arange(1, nb))[:2 * mb].reshape(2, mb)
    return bt


# (Hq, Hkv, D, NB, BS, table, slots, positions)
DECODE_CASES = {
    "unit_layout": (4, 2, 16, 16, 8, "unit", [0, 0, 1, 1, 0, 1, 2], [0, 13, 5, 8, 31, 17, 0]),
    "block_edges": (4, 2, 16, 16, 8, "unit", [0, 0, 0, 0], [7, 8, 15, 16]),
    "gqa4_d128_bs32": (8, 2, 128, 12, 32, "gqa", [0, 1, 0, 1, 2], [0, 31, 32, 127, 0]),
    # head dims the kernels take besides 128: the smallest bucket, one off
    # a power of two, and the largest
    "gqa4_d16": (8, 2, 16, 12, 8, "gqa", [0, 1, 0, 1, 2], [0, 7, 8, 31, 0]),
    "gqa4_d80": (8, 2, 80, 12, 8, "gqa", [0, 1, 0, 1, 2], [0, 7, 8, 31, 0]),
    "gqa4_d256": (8, 2, 256, 12, 8, "gqa", [0, 1, 0, 1, 2], [0, 7, 8, 31, 0]),
}

# (Hq, Hkv, D, NB, BS, CT, table, tile_slot, tile_pos0, tile_valid)
PREFILL_CASES = {
    # seq0 chunk of 14 tokens (tiles 0-1, pos 5..18), seq1 chunk of 6 tokens
    # (tile 2, pos 0..5, pad rows), tile 3 all-pad
    "unit_layout": (4, 2, 16, 16, 8, 8, "unit", [0, 0, 1, 2], [5, 13, 0, 0], [8, 6, 6, 0]),
    # tiles crossing block edges, pad rows, an all-pad tile
    "gqa4_d128_bs32": (8, 2, 128, 12, 32, 16, "gqa", [0, 0, 1, 2],
                       [24, 40, 31, 0], [16, 9, 16, 0]),
    "gqa4_d16": (8, 2, 16, 12, 8, 8, "gqa", [0, 0, 1, 2], [3, 11, 7, 0], [8, 5, 8, 0]),
    "gqa4_d80": (8, 2, 80, 12, 8, 8, "gqa", [0, 0, 1, 2], [3, 11, 7, 0], [8, 5, 8, 0]),
}


def _case_table(rng, kind, nb):
    return _unit_table() if kind == "unit" else _gqa_table(rng, nb, 4)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_plain_matches_pallas(case):
    hq, hkv, d, nb, bs, kind, slots, pos = DECODE_CASES[case]
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng, hkv, d, nb, bs)
    bt = _case_table(rng, kind, nb)
    q = rng.normal(size=(len(pos), hq, d)).astype(np.float32)
    slots = np.asarray(slots, np.int32)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_pallas.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, slots, pos, bt))))
    got = pa.paged_decode_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, slots, pos, bt)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the JAX XLA gather path agrees as well
    xla = np.asarray(jax_attention.paged_attention(
        *map(jnp.asarray, (q, kp, vp, slots, pos, bt)), impl="xla"))
    np.testing.assert_allclose(got.numpy(), xla, **TOL)


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_plain_matches_pallas(case):
    hq, hkv, d, nb, bs, ct, kind, ts, tp, tv = PREFILL_CASES[case]
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng, hkv, d, nb, bs)
    bt = _case_table(rng, kind, nb)
    q = rng.normal(size=(len(ts) * ct, hq, d)).astype(np.float32)
    meta = [np.asarray(x, np.int32) for x in (ts, tp, tv)]
    want = np.asarray(jax_pallas.ragged_prefill_attention(
        *map(jnp.asarray, (q, kp, vp, *meta, bt)), ct))
    got = pa.ragged_prefill_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, *meta, bt)), ct).numpy()
    # every row, pad rows and the all-pad tile included: the Pallas kernel
    # gives zeros there
    np.testing.assert_allclose(got, want, **TOL)
    # valid rows also match the JAX XLA fallback, whose pad rows differ
    # (they attend the scratch block)
    xla = np.asarray(jax_attention.ragged_prefill_attention(
        *map(jnp.asarray, (q, kp, vp, *meta, bt)), ct, impl="xla"))
    valid = np.concatenate([np.arange(ct) < v for v in tv])
    np.testing.assert_allclose(got[valid], xla[valid], **TOL)
    assert not got[~valid].any()


def _dispatch_inputs():
    hq, hkv, d, nb, bs, kind, slots, pos = DECODE_CASES["unit_layout"]
    rng = np.random.default_rng(1)
    kp, vp = map(torch.from_numpy, _pools(rng, hkv, d, nb, bs))
    bt = torch.from_numpy(_unit_table())
    q = torch.randn(len(pos), hq, d, generator=torch.Generator().manual_seed(0))
    return q, kp, vp, torch.tensor(slots), torch.tensor(pos), bt


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_dispatchers_take_plain_version_on_cpu(impl):
    q, kp, vp, slots_t, pos_t, bt = _dispatch_inputs()
    pa.reset_counts()
    dec = port_attention.paged_attention(q, kp, vp, slots_t, pos_t, bt, impl=impl)
    ref = pa.paged_decode_attention_ref(q, kp, vp, slots_t, pos_t, bt)
    torch.testing.assert_close(dec, ref, rtol=0, atol=0)
    ct = 4
    qp = q.repeat(2, 1, 1)[:2 * ct]
    meta = [torch.tensor(x, dtype=torch.int32) for x in ([0, 2], [3, 0], [4, 0])]
    pre = port_attention.ragged_prefill_attention(qp, kp, vp, *meta, bt, ct, impl=impl)
    torch.testing.assert_close(
        pre, pa.ragged_prefill_attention_ref(qp, kp, vp, *meta, bt, ct), rtol=0, atol=0)
    assert pa.paged_decode_attention.launches == 0
    assert pa.ragged_prefill_attention.launches == 0
    assert pa.paged_decode_attention_ref.calls == 2
    assert pa.ragged_prefill_attention_ref.calls == 2


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_dispatchers_reject_other_impls(impl):
    q, kp, vp, slots_t, pos_t, bt = _dispatch_inputs()
    with pytest.raises(ValueError, match="want 'auto' or 'plain'"):
        port_attention.paged_attention(q, kp, vp, slots_t, pos_t, bt, impl=impl)
    meta = [torch.tensor(x, dtype=torch.int32) for x in ([0], [0], [4])]
    with pytest.raises(ValueError, match="want 'auto' or 'plain'"):
        port_attention.ragged_prefill_attention(q[:4], kp, vp, *meta, bt, 4, impl=impl)


@pytest.mark.parametrize("tokens", [1, 4, 32, 128, 1024])
@pytest.mark.parametrize("table_width", [1, 4, 18, 64])
def test_decode_splits_cover_the_table_in_whole_blocks(tokens, table_width):
    """The decode kernel's split count comes from host sizes alone: at least
    one, at most the table's width, every split the same whole number of
    blocks and the last one holding at least one; more tokens never mean
    more splits; and a split call's partials and counters fit the fixed
    sizes of a ``DecodeWorkspace``, which never grows."""
    splits = pa.decode_splits(tokens, 8, table_width, 132)
    per_split = -(-table_width // splits)
    assert 1 <= splits <= table_width
    assert (splits - 1) * per_split < table_width <= splits * per_split
    assert pa.decode_splits(2 * tokens, 8, table_width, 132) <= splits
    assert pa.decode_splits(tokens, 8, table_width, 132) == splits  # no state
    for hq, d in ((8, 256), (32, 128), (256, 64)):  # GQA rep 1, 4 and 32
        need = pa._decode_sizes(tokens, hq, 8, d, splits)
        room = pa._workspace_sizes(hq, 8, d, 132)
        assert splits == 1 or (need[0] <= room[0] and need[1] <= room[1])


def test_decode_workspace_lives_on_the_card():
    """The decode kernel's workspace is made on a CUDA device; the CPU's
    plain version needs none, and a paged cache on the CPU holds none."""
    with pytest.raises(ValueError, match="CUDA device"):
        pa.DecodeWorkspace("cpu", 32, 8, 128)
    cache = llama.init_paged_cache(llama.LlamaConfig.tiny(), 4, 4)
    assert sorted(cache) == ["k", "v"]
