"""The engine's forward / backward / step protocol against ``train_batch``
and against the JAX engine's protocol, on the CPU (``LlamaConfig.tiny()``,
GAS 2, clipping 1.0, remat on, the same numpy weights on both sides):

- ``backward`` x 2 + ``step`` is the port's ``train_batch`` bit for bit
  (losses and every master, fp32 and bf16 compute), with
  ``is_gradient_accumulation_boundary`` false after the first micro-batch;
- against the JAX engine's ``backward`` / ``step``: losses rtol 1e-5 and
  masters 1e-5 absolute after 2 steps (fp32), ``forward``'s eval loss
  rtol 1e-5, and the engines' key streams (``_rng``, split once a
  forward and a backward) equal;
- ``backward`` refuses what the reference refuses, with its message.
"""

import copy
from functools import partial

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_keys
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.engine import initialize
from torch_serving_common import one_torch_thread  # noqa: F401

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
S, MB, GAS = 16, 2, 2


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(np.array, jax_llama.init_params(JCFG, jax.random.PRNGKey(0)))


def _config(bf16: bool):
    return {
        "train_micro_batch_size_per_device": MB, "gradient_accumulation_steps": GAS,
        "steps_per_print": 0, "gradient_clipping": 1.0, "sequence_length": S,
        "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                     "warmup_max_lr": 3e-3}},
        "mesh": {"data": 1}, "bf16": {"enabled": bf16},
        "activation_checkpointing": {"enabled": True, "policy": "dots_saveable"},
    }


def _batches(n=3):
    rng = np.random.default_rng(7)
    return [{"input_ids": rng.integers(0, CFG.vocab_size, (MB * GAS, S), dtype=np.int32)}
            for _ in range(n)]


def _micro(batch, g):
    return {k: v[g * MB:(g + 1) * MB] for k, v in batch.items()}


def _port(np_params, bf16=False):
    eng, _, _, _ = initialize(model=partial(llama.build, CFG), config=_config(bf16),
                              initial_params=np_params, device="cpu")
    return eng


def _fbs(eng, batch):
    losses = []
    for g in range(GAS):
        losses.append(eng.backward(_micro(batch, g)))
        assert eng.is_gradient_accumulation_boundary() == (g == GAS - 1)
    eng.step()
    return losses


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_step_is_train_batch_bitwise(np_params, bf16):
    a, b = _port(np_params, bf16), _port(np_params, bf16)
    for batch in _batches():
        want = a.train_batch(batch)
        got = torch.stack(_fbs(b, batch)).mean()
        assert torch.equal(got, want)
    for (k, p), (_, q) in zip(flatten_with_keys(a.params), flatten_with_keys(b.params)):
        assert torch.equal(p, q), k
    assert (a.global_steps, a.micro_steps) == (b.global_steps, b.micro_steps) == (3, 6)
    assert a.get_global_grad_norm() == b.get_global_grad_norm()


def test_protocol_matches_jax_engine(np_params):
    """fp32, 2 steps: losses rtol 1e-5, masters 1e-5 absolute, eval loss
    rtol 1e-5, key streams equal."""
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=lambda ctx: jax_llama.build(JCFG, ctx=ctx), config=copy.deepcopy(_config(False)),
        initial_params=np_params, mesh_devices=jax.devices()[:1])
    teng = _port(np_params)
    batches = _batches(2)
    jl, tl = [], []
    for batch in batches:
        for g in range(GAS):
            jl.append(float(jeng.backward(_micro(batch, g))))
        jeng.step()
        tl += [float(x) for x in _fbs(teng, batch)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = dict(flatten_with_keys(teng.module_state()))
    want = jax.tree_util.tree_flatten_with_path(jeng.module_state())[0]
    for path, w in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].detach().numpy(),
                                   np.asarray(w), atol=1e-5)
    ev = _micro(batches[0], 1)
    np.testing.assert_allclose(float(teng.forward(ev)), float(jeng.forward(ev)), rtol=1e-5)
    assert teng.eval_batch is not None and jeng.global_steps == teng.global_steps == 2
    np.testing.assert_array_equal(teng._rng.numpy().astype(np.uint32),
                                  np.asarray(jax.random.key_data(jeng._rng)
                                             if jax.dtypes.issubdtype(jeng._rng.dtype,
                                                                      jax.dtypes.prng_key)
                                             else jeng._rng).astype(np.uint32))


def test_backward_refuses_like_the_reference(np_params):
    eng = _port(np_params)
    eng.config.progressive_layer_drop.enabled = True  # init refuses it; backward must too
    with pytest.raises(NotImplementedError, match="use train_batch"):
        eng.backward(_micro(_batches(1)[0], 0))
