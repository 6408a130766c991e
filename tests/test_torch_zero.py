"""The port's ZeRO stages 0-3 over gloo ranks against the JAX engine on its
8-device CPU mesh (``mesh: {fsdp: 8}``), fp32, on ``LlamaConfig.tiny()``.

The same numpy weights and the same global batches (16 rows of 16 tokens,
GAS 2, so every micro-batch holds the same rows on both sides) go through
both; 4 steps of AdamW with clipping, activation checkpointing and the
warm-up schedule of ``tests/test_torch_train.py`` (under a constant lr
Adam's first steps are sign-like, and the JAX engine's own params at
``fsdp: 8`` and on one device then differ by 6.7e-5 after 3 steps; under
the warm-up by 1.2e-7):
- the port at world 2 (``fsdp: 2``), stages 0, 1, 2 and 3: losses within
  rtol 1e-5, final params within 1e-5 absolute;
- its stages 1-3 against its own stage 0: losses 1e-6 relative, params
  1e-6 absolute, Adam moments 1e-5 relative + 1e-8 absolute (only the
  order of the sums across ranks differs; a moment near zero keeps the
  cancellation's absolute error);
- world 4 on ``{data: 2, fsdp: 2}`` at stage 3;
- every batch carries labels whose ignored positions fall unevenly on the
  ranks (the port weights each rank's mean by its share of the target
  tokens; the checkpoint tests run batches without labels);
- ``utils/tensor_fragment`` getters and setter at stage 3 against the JAX
  package's.
"""

import functools

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm.topology import reset_topology
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.utils import tensor_fragment as jax_tf
from torch_dist_common import (FRAGMENT_CALLS, RankPool, batches, fragment_calls,
                               fragments_after_training, train)
from torch_ragged_common import shared

JCFG = jax_llama.LlamaConfig.tiny()
GLOBAL_ROWS, SEQ, GAS, STEPS = 16, 16, 2, 4



def config(stage: int, mesh: dict, dp: int) -> dict:
    return {
        "train_micro_batch_size_per_device": GLOBAL_ROWS // (GAS * dp),
        "gradient_accumulation_steps": GAS, "steps_per_print": 0,
        "gradient_clipping": 1.0, "sequence_length": SEQ,
        "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                     "warmup_max_lr": 3e-3}},
        "mesh": mesh, "bf16": {"enabled": False}, "zero_optimization": {"stage": stage},
        "activation_checkpointing": {"enabled": True, "policy": "dots_saveable"},
    }


@functools.cache
def np_params() -> dict:
    p = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.array, p)


def the_batches() -> list:
    out = batches(STEPS, GLOBAL_ROWS, SEQ, JCFG.vocab_size)
    rng = np.random.default_rng(7)
    for b in out:
        lab = np.roll(b["input_ids"], -1, axis=1).astype(np.int32)
        lab[:, -1] = -100
        lab[:5, : rng.integers(4, 12)] = -100   # rows of the first ranks only
        b["labels"] = lab
    return out


def _jax_run() -> dict:
    reset_topology()
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=lambda ctx: jax_llama.build(JCFG, ctx=ctx),
        config=config(3, {"data": 1, "fsdp": 8}, 8), initial_params=np_params())
    losses, norms = [], []
    for b in the_batches():
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    names = jax_tf.list_param_names(eng)
    out = {"losses": losses, "grad_norms": norms,
           "params": {n: jax_tf.safe_get_full_fp32_param(eng, n) for n in names},
           "fragments": fragment_calls(jax_tf, eng),
           "grad": jax_tf.safe_get_full_grad(eng, "embed")}
    reset_topology()
    return out


def jax_run() -> dict:
    return shared(_jax_run)


def _port_world2() -> dict:
    """The port's world-2 runs (``fsdp: 2``) on one gloo pool: every stage,
    then stage 3's ``tensor_fragment`` calls. Computed once a test run."""
    pool = RankPool(2)
    try:
        out = {stage: pool.run(train, config(stage, {"fsdp": 2}, 2), np_params(),
                               the_batches()) for stage in range(4)}
        out["fragments"] = pool.run(fragments_after_training, config(3, {"fsdp": 2}, 2),
                                    np_params(), the_batches())
    finally:
        pool.close()
    return out


def _port_world4() -> list:
    pool = RankPool(4)
    try:
        return pool.run(train, config(3, {"data": 2, "fsdp": 2}, 4), np_params(),
                        the_batches())
    finally:
        pool.close()


def port_run(stage) -> list:
    return shared(_port_world2)[stage]


def max_param_diff(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_world2_matches_jax_fsdp8(stage):
    want = jax_run()
    ranks = port_run(stage)
    for r in ranks:   # every rank reports the global loss and the full params
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], want["grad_norms"], rtol=1e-4)
        assert max_param_diff(r["params"], want["params"]) < 1e-5
    sharded = ranks[0]["owned"]["['layers']['wq']"]
    assert sharded == ((2, 32, 64) if stage == 3 else (2, 64, 64))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stages_match_stage0(stage):
    base, got = port_run(0)[0], port_run(stage)[0]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-6)
    assert max_param_diff(got["params"], base["params"]) < 1e-6
    assert got["count"] == base["count"] == STEPS
    for field in ("mu", "nu"):
        for k, v in base[field].items():
            np.testing.assert_allclose(got[field][k], v, rtol=1e-5, atol=1e-8, err_msg=k)


def test_world4_data2_fsdp2_stage3():
    want = jax_run()
    ranks = shared(_port_world4)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        assert max_param_diff(r["params"], want["params"]) < 1e-5
    # the data axis replicates: fsdp peers hold halves, data peers the same half
    assert [r["owned"]["['embed']"] for r in ranks] == [(128, 64)] * 4


def test_tensor_fragment_matches_jax():
    want = jax_run()["fragments"]
    ranks = port_run("fragments")
    for r in ranks:
        assert r["owned"] == (2, 32, 64)   # the getters gather across the shards
        for key in FRAGMENT_CALLS:
            np.testing.assert_allclose(r[key], want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=str(key))
        np.testing.assert_array_equal(r["set_get"], want["set_get"])
        assert r["grad"] is None and jax_run()["grad"] is None
