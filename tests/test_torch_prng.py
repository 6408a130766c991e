"""The port's threefry (``deepspeed_tpu_torch/utils/prng.py``) against
``jax.random`` on the CPU.

Keys, ``fold_in``, 32-bit ``random_bits`` over 1-D and 2-D shapes and
float32 ``uniform`` are integer work (uniform's float step is exact at the
bounds the sampler uses) and must be bit-identical. ``gumbel`` applies
``log`` twice, and XLA's ``logf`` and torch's differ in the last bit (at
most one ulp, measured on these keys): -log of a value near 1 turns that
into many ulps of a result near 0, so gumbel is held to 2 ulp of
max(1, |value|). ``categorical`` picks, the argmax over gumbel + logits,
must be identical over 256 keys.

The bits are those of ``jax_threefry_partitionable=True``, the mode of the
JAX the reference runs on; the test asserts the mode, so a change in it
fails here rather than skipping.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.utils import prng
from torch_serving_common import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 7, 0x5A3D1E, 2**31 - 1, 2**31 + 5, -1, 2**32 + 9)
SHAPES = ((1,), (7,), (97,), (256,), (3, 11), (4, 97), (16, 256))


def _key(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_reference_prng_mode_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True, (
        "the reference's PRNG mode changed: utils/prng.py copies the "
        "partitionable threefry bits")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_words(jk), tk.numpy())


@pytest.mark.parametrize("data", (0, 1, 5, 12345, 2**31 - 1, 2**32 - 1))
def test_fold_in(data):
    for seed in SEEDS:
        jk, tk = _key(seed)
        np.testing.assert_array_equal(_words(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())


def test_fold_in_batched_data():
    """A key folded with a vector of data, as ``per_request_keys`` folds
    seeds and token indices; negative data wraps as a uint32 cast does."""
    jk, tk = _key(0x5A3D1E)
    data = np.array([0, 3, -1, -7, 2**31 - 1, 99], np.int32)
    want = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(data))
    np.testing.assert_array_equal(_words(want), prng.fold_in(tk, torch.from_numpy(data)).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits(shape):
    for seed in SEEDS[:5]:
        jk, tk = _key(seed)
        want = jax.random.bits(jk, shape, jnp.uint32)
        np.testing.assert_array_equal(_words(want), prng.random_bits(tk, shape).numpy())


def test_random_bits_per_row_keys():
    """A batch of keys draws each row from its own key, as ``jax.vmap``."""
    jk, tk = _key(3)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(5))
    tkeys = prng.fold_in(tk, torch.arange(5))
    want = jax.vmap(lambda k: jax.random.bits(k, (97,), jnp.uint32))(jkeys)
    np.testing.assert_array_equal(_words(want), prng.random_bits(tkeys, (97,)).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bounds", ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)),
                         ids=("unit", "gumbel"))
def test_uniform(shape, bounds):
    for seed in SEEDS[:5]:
        jk, tk = _key(seed)
        want = np.asarray(jax.random.uniform(jk, shape, minval=bounds[0], maxval=bounds[1]))
        got = prng.uniform(tk, shape, *bounds).numpy()
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_gumbel_within_two_ulp():
    jk, tk = _key(42)
    for i in range(64):
        want = np.asarray(jax.random.gumbel(jax.random.fold_in(jk, i), (16, 256)))
        got = prng.gumbel(prng.fold_in(tk, i), (16, 256)).numpy()
        ulp = np.spacing(np.maximum(1.0, np.abs(want)).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp)


@functools.partial(jax.jit, static_argnames="per_row")
def _jax_categorical(key, i, logits, per_row):
    """``jax.random.categorical`` with ``fold_in(key, i)``, one row a key
    (folded with the row) or one key for all: one compile for the 256
    draws, as the engines draw it inside their compiled programs."""
    k = jax.random.fold_in(key, i)
    if per_row:
        keys = jax.vmap(lambda r: jax.random.fold_in(k, r))(jnp.arange(logits.shape[0]))
        return jax.vmap(jax.random.categorical)(keys, logits)
    return jax.random.categorical(k, logits, axis=-1)


@pytest.mark.parametrize("per_row", (False, True), ids=("one_key", "per_row_keys"))
def test_categorical_identical_over_256_keys(per_row):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((8, 97)) * 2).astype(np.float32)
    jk, tk = _key(11)
    jlogits = jnp.asarray(logits)
    for i in range(256):
        want = _jax_categorical(jk, i, jlogits, per_row=per_row)
        tki = prng.fold_in(tk, i)
        if per_row:
            got = prng.categorical(prng.fold_in(tki, torch.arange(8)), torch.from_numpy(logits))
        else:
            got = prng.categorical(tki, torch.from_numpy(logits))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
