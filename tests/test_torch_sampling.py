"""The port's sampler (``deepspeed_tpu_torch/inference/sampling.py``)
against the reference's on the CPU: ``sample_tokens`` over every
combination of greedy and tempered rows, top-k, top-p and the repetition
penalty, with one key and with per-row keys; the per-request key
derivations; the occurrence mask. Tokens must be identical and logprobs
within 1e-5 (the log-softmax sums in another order); keys and masks are
integers and must be identical.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as jax_sampling
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.utils import prng
from torch_serving_common import one_torch_thread  # noqa: F401

T, V = 6, 97
LP_ATOL = 1e-5
ROOT = 0x5A3D1E


def _inputs(trial: int):
    rng = np.random.default_rng(trial)
    return dict(
        logits=(rng.standard_normal((T, V)) * 3).astype(np.float32),
        seen=rng.random((T, V)) < 0.2,
        temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.0], np.float32),
        top_k=np.array([0, 5, 20, 0, 1, 3], np.int32),
        top_p=np.array([1.0, 0.9, 0.5, 0.95, 1.0, 0.8], np.float32),
        penalty=np.array([1.0, 1.2, 0.8, 1.0, 1.5, 1.3], np.float32))


def _keys(per_row: bool, seed: int):
    if not per_row:
        return jax.random.PRNGKey(seed), prng.prng_key(seed)
    seeds = np.arange(T, dtype=np.int32) + seed
    gen = np.arange(T, dtype=np.int32) * 2 - 1
    return (jax_sampling.per_request_keys(jax.random.PRNGKey(ROOT), jnp.asarray(seeds),
                                          jnp.asarray(gen)),
            sampling.per_request_keys(prng.prng_key(ROOT), torch.from_numpy(seeds),
                                      torch.from_numpy(gen)))


@pytest.mark.parametrize("per_row", (False, True), ids=("one_key", "per_row_keys"))
@pytest.mark.parametrize("temp,top_k,top_p,penalty",
                         list(itertools.product(("greedy", "tempered", "mixed"), (0, 1), (0, 1),
                                                (0, 1))))
def test_sample_tokens_identical(per_row, temp, top_k, top_p, penalty):
    for trial in range(8):
        x = _inputs(trial)
        t = {"greedy": np.zeros(T, np.float32), "tempered": np.full(T, 0.8, np.float32),
             "mixed": x["temperature"]}[temp]
        jk, tk = _keys(per_row, 100 * trial + 7)
        jkw = dict(top_k=jnp.asarray(x["top_k"]) if top_k else None,
                   top_p=jnp.asarray(x["top_p"]) if top_p else None,
                   repetition_penalty=jnp.asarray(x["penalty"]) if penalty else None,
                   seen_mask=jnp.asarray(x["seen"]) if penalty else None)
        tkw = {k: (None if v is None else torch.from_numpy(np.array(v)))
               for k, v in jkw.items()}
        want, want_lp = jax_sampling.sample_tokens(jnp.asarray(x["logits"]), jk,
                                                   jnp.asarray(t), **jkw)
        got, got_lp = sampling.sample_tokens(torch.from_numpy(x["logits"]), tk,
                                             torch.from_numpy(t), **tkw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0, atol=LP_ATOL)


def test_scalar_controls_broadcast():
    """Scalar controls broadcast to every row, as ``as_row`` does; bf16
    logits are cast to fp32 first."""
    x = _inputs(3)
    lg = jnp.asarray(x["logits"]).astype(jnp.bfloat16)
    want, want_lp = jax_sampling.sample_tokens(lg, jax.random.PRNGKey(5), 0.9, top_k=7,
                                               top_p=0.8)
    got, got_lp = sampling.sample_tokens(
        torch.from_numpy(np.array(lg.astype(jnp.float32))).to(torch.bfloat16),
        prng.prng_key(5), 0.9, top_k=7, top_p=0.8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0, atol=LP_ATOL)


def test_filters_and_penalty_identical():
    x = _inputs(1)
    lg = jnp.asarray(x["logits"])
    tlg = torch.from_numpy(x["logits"])
    np.testing.assert_array_equal(
        np.asarray(jax_sampling._mask_top_k(lg, jnp.asarray(x["top_k"]))),
        sampling._mask_top_k(tlg, torch.from_numpy(x["top_k"])).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_sampling._mask_top_p(lg, jnp.asarray(x["top_p"]))),
        sampling._mask_top_p(tlg, torch.from_numpy(x["top_p"])).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_sampling.apply_repetition_penalty(lg, jnp.asarray(x["seen"]),
                                                         jnp.asarray(x["penalty"]))),
        sampling.apply_repetition_penalty(tlg, torch.from_numpy(x["seen"]),
                                          torch.from_numpy(x["penalty"])).numpy())


def test_per_request_keys_and_positions():
    seeds = np.array([0, 7, 2**31 - 1, 123, 5], np.int32)
    positions = np.array([3, 10, 0, 64, 7], np.int32)
    plens = np.array([4, 4, 1, 20, 9], np.int32)  # the first and last index -1 and -1
    root_j, root_t = jax.random.PRNGKey(ROOT), prng.prng_key(ROOT)
    want = jax_sampling.keys_for_positions(root_j, jnp.asarray(seeds), jnp.asarray(positions),
                                           jnp.asarray(plens))
    got = sampling.keys_for_positions(root_t, torch.from_numpy(seeds),
                                      torch.from_numpy(positions), torch.from_numpy(plens))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    gen = positions - plens + 1
    np.testing.assert_array_equal(
        np.asarray(jax_sampling.per_request_keys(root_j, jnp.asarray(seeds),
                                                 jnp.asarray(gen))).astype(np.int64),
        sampling.per_request_keys(root_t, torch.from_numpy(seeds),
                                  torch.from_numpy(gen)).numpy())


def test_update_seen():
    rng = np.random.default_rng(2)
    seen = rng.random((T, V)) < 0.1
    toks = rng.integers(0, V, T).astype(np.int32)
    want = jax_sampling.update_seen(jnp.asarray(seen), jnp.asarray(toks))
    got = sampling.update_seen(torch.from_numpy(seen.copy()), torch.from_numpy(toks))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
