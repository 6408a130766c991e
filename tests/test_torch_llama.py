"""The port's Llama ragged path against the JAX package's, on a tiny config
(2 layers, hidden 64, 4 heads, 2 KV heads), fp32 on the CPU.

Parameters cross over through ``deepspeed_tpu_torch.models.convert``; the
cache and the batch are made with numpy from a seed. JAX's CPU path attends
with its XLA gather, whose tiled-prefill pad rows attend the scratch block
while the port's (and the Pallas kernel's) give zeros, so logits are
compared on real rows only; pad rows write their KV into scratch block 0 on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops.attention import apply_rope as jax_apply_rope
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.ops.attention import apply_rope
from torch_serving_common import one_torch_thread  # noqa: F401

ATOL = 1e-4
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
           num_heads=4, num_kv_heads=2, max_seq_len=128)
NB, BS, MB = 16, 8, 4


@pytest.fixture(scope="module")
def np_params():
    p = jax_llama.init_params(jax_llama.LlamaConfig(**CFG), jax.random.PRNGKey(0))
    # copies, not views: a numpy view keeps its JAX buffer in jax.live_arrays()
    return jax.tree_util.tree_map(np.array, p)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax_llama.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = llama.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# RoPE at long positions: an fp32 angle near 8192 has an ulp of 9.8e-4, and
# the two frameworks' fp32 frequencies (pow) and sin/cos differ by an ulp or
# so, so at head dim 128 and positions up to 8192 (Llama-3-8B's context,
# theta 5e5) the outputs differ by up to 1.7e-3 (each side is ~1e-3 from a
# float64 evaluation). Tolerance there: 4e-3.
LONG_ROPE_ATOL = 4e-3


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    # (positions up to, head dim, atol): the 8B serving config's context (576)
    # at ATOL, then training's and the model's full context at LONG_ROPE_ATOL
    for max_pos, d, atol in ((576, 16, ATOL), (8192, 128, LONG_ROPE_ATOL)):
        q = rng.normal(size=(2, 7, 4, d)).astype(np.float32)
        k = rng.normal(size=(2, 7, 2, d)).astype(np.float32)
        pos = rng.integers(0, max_pos, size=(2, 7)).astype(np.int32)
        pos[0, 0] = max_pos - 1
        wq, wk = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), theta)
        gq, gk = apply_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos),
                            theta)
        np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=atol)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=atol)


def _table():
    # slots 0-3 own disjoint blocks; row 4 is the all-scratch padding row
    bt = np.zeros((5, MB), np.int32)
    bt[0] = [3, 5, 7, 11]
    bt[1] = [2, 9, 1, 12]
    bt[2] = [4, 6, 8, 10]
    bt[3] = [13, 14, 15, 0]
    return bt


def _batch(rows):
    """[(token, slot, position)] -> int32 arrays."""
    return [np.asarray(c, np.int32) for c in zip(*rows)]


def _run_both(np_params, tokens, slots, positions, tiles=None):
    rng = np.random.default_rng(2)
    cfg = jax_llama.LlamaConfig(**CFG)
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.hd)
    cache = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32)}
    bt = _table()
    jt = None if tiles is None else (tiles[0], *map(jnp.asarray, tiles[1:4]), tiles[4])
    want, jcache = jax_llama.ragged_forward(
        cfg, jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(tokens),
        jnp.asarray(slots), jnp.asarray(positions), jnp.asarray(bt),
        jax.tree_util.tree_map(jnp.asarray, cache), prefill_tiles=jt)
    pt = None if tiles is None else (tiles[0], *map(torch.from_numpy, tiles[1:4]), tiles[4])
    got, pcache = llama.ragged_forward(
        llama.LlamaConfig(**CFG), params_from_numpy(np_params), torch.from_numpy(tokens),
        torch.from_numpy(slots), torch.from_numpy(positions), torch.from_numpy(bt),
        params_from_numpy(cache), prefill_tiles=pt)
    return (got.numpy(), {k: v.numpy() for k, v in pcache.items()},
            np.asarray(want), {k: np.asarray(v) for k, v in jcache.items()})


def _assert_match(got, pcache, want, jcache, slots):
    real = slots < 4
    np.testing.assert_allclose(got[real], want[real], atol=ATOL, rtol=0)
    for name in ("k", "v"):  # every block but scratch block 0
        np.testing.assert_allclose(pcache[name][:, 1:], jcache[name][:, 1:], atol=ATOL)


def test_ragged_forward_matches_jax(np_params):
    # decodes at a block edge and mid-block, a prefill chunk, two pad rows
    rows = [(7, 0, 13), (9, 1, 20), (11, 2, 8)]
    rows += [(20 + i, 3, i) for i in range(9)]
    rows += [(0, 4, 0), (0, 4, 0)]
    tokens, slots, positions = _batch(rows)
    got, pcache, want, jcache = _run_both(np_params, tokens, slots, positions)
    _assert_match(got, pcache, want, jcache, slots)


def test_ragged_forward_tiled_matches_jax(np_params):
    ct = 8
    # decode region (bucketed to 4, one pad row), then tiles: slot 3 at
    # positions 0..12 (a full tile, a tile with 3 pad rows), one all-pad tile
    rows = [(7, 0, 13), (9, 1, 20), (11, 2, 7), (0, 4, 0)]
    rows += [(30 + i, 3, i) for i in range(8)]
    rows += [(40 + i, 3, 8 + i) for i in range(5)] + [(0, 4, 0)] * 3
    rows += [(0, 4, 0)] * ct
    tokens, slots, positions = _batch(rows)
    tiles = (4, np.asarray([3, 3, 4], np.int32), np.asarray([0, 8, 0], np.int32),
             np.asarray([8, 5, 0], np.int32), ct)
    got, pcache, want, jcache = _run_both(np_params, tokens, slots, positions, tiles)
    _assert_match(got, pcache, want, jcache, slots)


def test_params_round_trip(np_params):
    back = params_to_numpy(params_from_numpy(np_params))
    flat = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        other = back
        for key in path:
            other = other[key.key]
        assert other.dtype == leaf.dtype and other.shape == leaf.shape
        np.testing.assert_array_equal(other, leaf)
    # bf16 on the way in widens back to fp32 on the way out, within bf16 rounding
    bf = params_to_numpy(params_from_numpy(np_params, dtype=torch.bfloat16))
    assert bf["embed"].dtype == np.float32
    np.testing.assert_allclose(bf["embed"], np_params["embed"], rtol=2 ** -8)
