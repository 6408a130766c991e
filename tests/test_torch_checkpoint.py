"""Checkpoints across the two packages, on the CPU.

The port writes and reads the JAX package's sharded format
(``{name}.index.json`` + ``{name}_shard_p{rank}.npz``, leaves keyed by
``jax.tree_util.keystr``) through the same two-phase commit. On
``LlamaConfig.tiny()`` in fp32, for AdamW, Adam with L2 decay and SGD with
momentum (the optimizer state's keys are read from the JAX checkpoint), at
one layer without activation checkpointing (the JAX engine compiles a
step for each optimizer and direction):
- JAX -> port: the JAX engine at ZeRO 2 on ``fsdp: 8`` trains 2 steps and
  saves; the port loads it with verification at world 1 (stage 0) and at
  world 2 (stage 3, gloo): params, moments, step count, counters, lr
  scheduler and loss-scale state bitwise equal to the file, and 2 more
  steps within rtol 1e-5 of the JAX engine's own next 2;
- port -> JAX: the port at world 2, stage 3, trains 2 steps and saves;
  ``deepspeed_tpu.checkpoint.engine.verify_checkpoint`` passes, the JAX
  engine loads it bitwise and its next 2 steps agree with the port's
  within rtol 1e-5;
- resume equals continuous (bitwise at the same world and stage);
  ``keep_n_latest``; ``async_save``; a fault at ``ckpt.commit`` leaves the
  previous checkpoint loadable; a fragment truncated at load walks the
  fallback ladder to the older tag.
"""

import dataclasses
import functools
import os
import tempfile

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.checkpoint import engine as jax_ckpt
from deepspeed_tpu.checkpoint import sharded as jax_sharded
from deepspeed_tpu.comm.topology import reset_topology
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.serving import faults
import torch_dist_common as dc
from torch_dist_common import RankPool, batches, full_state
from torch_ragged_common import shared

LAYERS = 1
JCFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), num_layers=LAYERS)
ROWS, SEQ = 8, 16
OPTIMIZERS = {
    "adamw": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "adam_l2": {"type": "adam", "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "sgd_momentum": {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9}},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(opt: str, stage: int, mesh: dict, dp: int, **extra) -> dict:
    return {"train_micro_batch_size_per_device": ROWS // dp,
            "gradient_accumulation_steps": 1, "steps_per_print": 0,
            "gradient_clipping": 1.0, "sequence_length": SEQ,
            "optimizer": OPTIMIZERS[opt],
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                         "warmup_max_lr": 3e-3}},
            "mesh": mesh, "bf16": {"enabled": False}, "zero_optimization": {"stage": stage},
            **extra}


WORLD1 = dict(stage=0, mesh={"data": -1}, dp=1)
WORLD2_Z3 = dict(stage=3, mesh={"fsdp": 2}, dp=2)


@functools.cache
def np_params() -> dict:
    return jax.tree_util.tree_map(np.array, jax_llama.init_params(JCFG, jax.random.PRNGKey(1)))


def the_batches() -> list:
    return batches(4, ROWS, SEQ, JCFG.vocab_size, seed=200)


@functools.cache
def run_dir() -> str:
    """A directory every xdist worker of this run shares (the JAX
    checkpoints live there), else a fresh one."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return tempfile.mkdtemp(prefix="dstpu-ckpt-")
    path = os.path.join(tempfile.gettempdir(), f"dstpu-torch-tests-{run}", "ckpt")
    os.makedirs(path, exist_ok=True)
    return path


def jax_engine(opt: str):
    reset_topology()
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=lambda ctx: jax_llama.build(JCFG, ctx=ctx),
        config=config(opt, 2, {"data": 1, "fsdp": 8}, 8), initial_params=np_params())
    return eng


def file_state(ckpt_dir: str) -> dict:
    """Every leaf of a checkpoint, assembled by the JAX package's reader."""
    return {**jax_sharded.assemble_full(ckpt_dir, "model"),
            **jax_sharded.assemble_full(ckpt_dir, "optimizer")}


def port_dir(opt: str) -> str:
    return os.path.join(run_dir(), f"port-{opt}")


def _port_saves() -> dict:
    """The port at world 2, stage 3, for each optimizer: 2 steps, a save, 2
    more steps; and, for AdamW, the same engine set-up resumed from that
    save. One gloo pool, once a test run."""
    bs = the_batches()
    out = {}
    pool = RankPool(2)
    try:
        for opt in OPTIMIZERS:
            out[opt] = pool.run(dc.train_save_continue, config(opt, **WORLD2_Z3), np_params(),
                                bs[:2], bs[2:], port_dir(opt), LAYERS)
        out["resumed"] = pool.run(dc.load_continue, config("adamw", **WORLD2_Z3),
                                  port_dir("adamw"), bs[2:], 9, LAYERS)
    finally:
        pool.close()
    return out


def port_saves() -> dict:
    return shared(_port_saves)


def jax_state(eng) -> dict:
    """The JAX engine's live state under the checkpoint's keys."""
    out = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(eng.params)[0]}
    out.update({jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(eng.opt_state)[0]})
    return out


def _jax_side(opt: str) -> dict:
    """One JAX engine: 2 steps, a save, 2 more steps; then it loads the
    port's save of ``_port_saves`` (which the caller made first), is held
    to that file bitwise, and takes the same 2 more steps."""
    eng = jax_engine(opt)
    bs = the_batches()
    first = [float(eng.train_batch(b)) for b in bs[:2]]
    save_dir = os.path.join(run_dir(), f"jax-{opt}")
    path = eng.save_checkpoint(save_dir)
    after = [float(eng.train_batch(b)) for b in bs[2:]]
    port_manifest = jax_ckpt.verify_checkpoint(os.path.join(port_dir(opt), "global_step2"))
    port_file = file_state(os.path.join(port_dir(opt), "global_step2"))
    loaded, _ = eng.load_checkpoint(port_dir(opt))
    live = jax_state(eng)
    differ = sorted(k for k, v in port_file.items()
                    if k not in live or live[k].dtype != v.dtype
                    or not np.array_equal(live[k], v))
    counters = (eng.global_steps, eng.global_samples, eng.micro_steps)
    after_port = [float(eng.train_batch(b)) for b in bs[2:]]
    reset_topology()
    return {"path": path, "save_dir": save_dir, "before": first, "after": after,
            "file": file_state(path), "manifest": jax_ckpt.verify_checkpoint(path),
            "port_manifest": port_manifest, "port_loaded": loaded,
            "port_keys_equal": set(live) == set(port_file), "port_leaves_differ": differ,
            "port_counters": counters, "after_port": after_port}


def jax_side(opt: str) -> dict:
    port_saves()   # the port's checkpoint the JAX engine loads
    return shared(_jax_side, opt)


def _port_loads() -> dict:
    """The port at world 2, stage 3, loads each JAX checkpoint and takes 2
    more steps. One gloo pool, once a test run."""
    pool = RankPool(2)
    try:
        return {opt: pool.run(dc.load_continue, config(opt, **WORLD2_Z3),
                              os.path.join(run_dir(), f"jax-{opt}"), the_batches()[2:], 9,
                              LAYERS)
                for opt in OPTIMIZERS}
    finally:
        pool.close()


def port_loads() -> dict:
    for opt in OPTIMIZERS:
        jax_side(opt)   # the JAX checkpoints it loads
    return shared(_port_loads)


def keystr(name: str) -> str:
    return "".join(f"[{p!r}]" for p in name.split("/"))


def assert_state_is_file(state: dict, file: dict, manifest: dict) -> None:
    """A loaded engine's full state against a checkpoint's arrays, bitwise;
    the optimizer's keys are the file's own."""
    for name, value in state["params"].items():
        np.testing.assert_array_equal(value, file[keystr(name)], err_msg=name)
    for field in ("mu", "nu", "trace"):
        if field not in state:
            continue
        for name, value in state[field].items():
            (key,) = [k for k in file if k.endswith(f".{field}{keystr(name)}")]
            np.testing.assert_array_equal(value, file[key], err_msg=key)
    counts = [k for k in file if k.endswith(".count")]
    if state["count"] is not None:
        (key,) = counts
        assert state["count"] == int(file[key]) and file[key].dtype == np.int32
    else:
        assert not counts
    assert state["counters"] == (manifest["global_steps"], manifest["global_samples"],
                                 manifest["micro_steps"], manifest["skipped_steps"])
    assert state["lr_scheduler"] == manifest["lr_scheduler"]
    assert state["scale_state"] == manifest["scale_state"]


build = functools.partial(dc.build, layers=LAYERS)
load_continue = functools.partial(dc.load_continue, layers=LAYERS)


# --------------------------------------------------------------- JAX -> port
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_jax_checkpoint_loads_in_port_world1(opt):
    want = jax_side(opt)
    got = load_continue(config(opt, **WORLD1), want["save_dir"], the_batches()[2:])
    assert got["path"] == want["path"]
    assert_state_is_file(got, want["file"], want["manifest"])
    np.testing.assert_allclose(got["losses"], want["after"], rtol=1e-5)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_jax_checkpoint_loads_in_port_world2_stage3(opt):
    want = jax_side(opt)
    for got in port_loads()[opt]:
        assert got["path"] == want["path"]
        assert_state_is_file(got, want["file"], want["manifest"])
        np.testing.assert_allclose(got["losses"], want["after"], rtol=1e-5)


# --------------------------------------------------------------- port -> JAX
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_port_checkpoint_loads_in_jax(opt):
    port = port_saves()[opt][0]
    assert sorted(f for f in os.listdir(port["path"]) if f.endswith(".npz")) == [
        "model_shard_p0.npz", "model_shard_p1.npz",
        "optimizer_shard_p0.npz", "optimizer_shard_p1.npz"]
    got = jax_side(opt)
    manifest = got["port_manifest"]   # deepspeed_tpu's verify_checkpoint passed
    assert manifest["commit_protocol"] == 2 and manifest["world_size"] == 2
    assert got["port_loaded"] == port["path"]
    assert got["port_keys_equal"] and got["port_leaves_differ"] == []
    assert got["port_counters"] == (2, 2 * ROWS, 2)
    np.testing.assert_allclose(got["after_port"], port["after"], rtol=1e-5)


# ----------------------------------------------------------- the port alone
def test_resume_equals_continuous():
    """The same world and stage: bitwise. World 1 at stage 0 from a world-2
    stage-3 save: rtol 1e-5 (the sums across ranks order differently)."""
    saves = port_saves()
    for c, r in zip(saves["adamw"], saves["resumed"]):
        assert r["losses"] == c["after"]
    w1 = load_continue(config("adamw", **WORLD1), port_dir("adamw"), the_batches()[2:])
    np.testing.assert_allclose(w1["losses"], saves["adamw"][0]["after"], rtol=1e-5)


def test_keep_n_latest():
    save_dir = tempfile.mkdtemp(prefix="dstpu-rotate-")
    eng = build(config("adamw", **WORLD1, checkpoint={"keep_n_latest": 2}), np_params())
    for b in the_batches()[:3]:
        eng.train_batch(b)
        eng.save_checkpoint(save_dir)
    assert ckpt.list_tags(save_dir) == ["global_step3", "global_step2"]
    assert ckpt.latest_tag(save_dir) == "global_step3"
    eng.destroy()


def test_async_save():
    save_dir = tempfile.mkdtemp(prefix="dstpu-async-")
    eng = build(config("adamw", **WORLD1, checkpoint={"async_save": True}), np_params())
    eng.train_batch(the_batches()[0])
    want = full_state(eng)
    path = eng.save_checkpoint(save_dir)
    eng.train_batch(the_batches()[1])   # trains while the writer flushes
    eng.destroy()                       # joins the writer
    jax_ckpt.verify_checkpoint(path)
    got = load_continue(config("adamw", **WORLD1), save_dir, [])
    for name, value in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], value, err_msg=name)
    assert got["counters"] == want["counters"]


def test_fault_at_commit_keeps_the_previous_checkpoint():
    save_dir = tempfile.mkdtemp(prefix="dstpu-commit-")
    eng = build(config("adamw", **WORLD1), np_params())
    eng.train_batch(the_batches()[0])
    first = eng.save_checkpoint(save_dir)
    eng.train_batch(the_batches()[1])
    inj = faults.get_fault_injector()
    inj.configure([{"point": faults.POINT_CKPT_COMMIT, "kind": "raise"}])
    try:
        with pytest.raises(faults.FaultError):
            eng.save_checkpoint(save_dir)
    finally:
        inj.reset()
    # the sealed staging dir is left behind, never promoted or pointed at
    assert os.path.isdir(ckpt.staging_dir(save_dir, "global_step2"))
    assert ckpt.list_tags(save_dir) == ["global_step1"]
    assert ckpt.latest_tag(save_dir) == "global_step1"
    got = load_continue(config("adamw", **WORLD1), save_dir, [])
    assert got["path"] == first and got["counters"][0] == 1
    eng.destroy()


def test_truncated_fragment_walks_the_ladder():
    save_dir = tempfile.mkdtemp(prefix="dstpu-ladder-")
    eng = build(config("sgd_momentum", **WORLD1), np_params())
    for b in the_batches()[:2]:
        eng.train_batch(b)
        eng.save_checkpoint(save_dir)
    eng.destroy()
    inj = faults.get_fault_injector()
    # the seam hands the kind the newest candidate's biggest file
    inj.configure([{"point": faults.POINT_CKPT_LOAD, "kind": "truncate"}])
    try:
        got = load_continue(config("sgd_momentum", **WORLD1), save_dir, [])
    finally:
        inj.reset()
    assert got["path"] == os.path.join(save_dir, "global_step1")
    assert got["counters"][0] == 1
    with pytest.raises(ckpt.CheckpointCorruptError) as err:
        ckpt.verify_checkpoint(os.path.join(save_dir, "global_step2"))
    assert err.value.stage == "size-mismatch"
    with pytest.raises(jax_ckpt.CheckpointCorruptError):
        jax_ckpt.verify_checkpoint(os.path.join(save_dir, "global_step2"))
