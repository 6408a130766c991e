"""The port's sentinel and checkpointable loaders against the JAX package's,
on the CPU.

- ``verdict``'s state trajectory over a seeded sequence of losses and grad
  norms with warm-up, spikes, NaN and a skip streak, against the JAX
  ``verdict`` under ``jax.jit`` (as the JAX step runs it): equal bits;
- the ring quantile against ``jnp.quantile`` (linear): equal bits;
- ``batch_fingerprint`` strings equal;
- quarantine and heartbeat files written by one package read by the other;
- ``SentinelPolicy`` actions equal over one sequence of calls;
- the in-process self-healing run (the chaos worker's config with bf16
  compute off: nan-grads, then a poisoned batch) against the JAX engine's
  same run, losses rtol 1e-5, and stitched against its clean run
  pre-seeded with the quarantine, bit for bit. In bf16 (the worker's
  default) the packages round activations at different places
  (``tests/test_torch_train.py``: losses within 1e-3), and Adam at lr 1e-2
  carries that into later steps;
- ``CheckpointableLoader`` / ``RepeatingLoader`` state across packages both
  ways, and the array and token loaders' batches.
"""

import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import load_config as jax_load_config
from deepspeed_tpu.elasticity import agent as jax_agent
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu.runtime import sentinel as jax_sent
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.elasticity import agent
from deepspeed_tpu_torch.runtime import chaos
from deepspeed_tpu_torch.runtime import dataloader as dl
from deepspeed_tpu_torch.runtime import sentinel as sent
from torch_ragged_common import shared
from torch_serving_common import one_torch_thread  # noqa: F401

FP32 = {"bf16": {"enabled": False}}
SENT = {"enabled": True, "warmup_steps": 3, "grad_window": 4, "max_consecutive_skips": 2,
        "loss_sigma_k": 3.0}


def _sequence():
    """(loss, gnorm, finite): warm-up, ordinary noise, a loss spike, a grad
    spike, NaN loss, a non-finite grad flag, a three-step streak, recovery."""
    rng = np.random.default_rng(3)
    seq = [(float(5.0 - 0.05 * i + 0.02 * rng.standard_normal()),
            float(1.0 + 0.1 * rng.standard_normal()), True) for i in range(10)]
    seq += [(40.0, 1.0, True), (4.4, 50.0, True), (float("nan"), 1.0, True),
            (4.4, 1.0, False), (90.0, 1.0, True), (95.0, 1.0, True), (99.0, 80.0, True)]
    seq += [(float(4.3 - 0.01 * i), float(0.9 + 0.05 * rng.standard_normal()), True)
            for i in range(8)]
    return seq


def test_verdict_trajectory_matches_jax():
    """Equal bits, step by step: the state, the anomaly, reason and streak."""
    jcfg = jax_load_config({"sentinel": SENT}).sentinel
    tcfg = load_config({"sentinel": SENT}).sentinel
    jstep = jax.jit(lambda s, l, g, f: jax_sent.verdict(s, l, g, f, jcfg))
    js, ts = jax_sent.init_state(jcfg), sent.init_state(tcfg)
    anomalies = 0
    for loss, gnorm, finite in _sequence():
        js, ja, jr, jk = jstep(js, jnp.float32(loss), jnp.float32(gnorm), jnp.asarray(finite))
        ts, ta, tr, tk = sent.verdict(ts, torch.tensor(loss, dtype=torch.float32),
                                      torch.tensor(gnorm, dtype=torch.float32),
                                      torch.tensor(finite), tcfg)
        assert (bool(ta), int(tr), int(tk)) == (bool(ja), int(jr), int(jk))
        for name, want in js._asdict().items():
            got = getattr(ts, name).numpy()
            np.testing.assert_array_equal(got.view(np.uint32) if got.dtype == np.float32
                                          else got,
                                          np.asarray(want).view(np.uint32)
                                          if np.asarray(want).dtype == np.float32
                                          else np.asarray(want), err_msg=name)
        anomalies += bool(ta)
    assert anomalies == 7  # every injected case is caught


def test_verdict_waits_for_nothing_on_the_host(monkeypatch):
    """The verdict adds no sync to the step: it builds no tensor from host
    data (``torch.tensor`` / ``as_tensor`` copy from pageable memory on the
    card, a wait) and reads none back (``item``, ``tolist``, ``bool``, an
    index by a 0-d tensor), over the whole sequence."""
    tcfg = load_config({"sentinel": SENT}).sentinel
    ts = sent.init_state(tcfg)
    inputs = [(torch.tensor(loss, dtype=torch.float32), torch.tensor(gnorm, dtype=torch.float32),
               torch.tensor(finite)) for loss, gnorm, finite in _sequence()]

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"verdict called {name}")
        return fn

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))
    for name in ("item", "tolist", "__bool__", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    for loss, gnorm, finite in inputs:
        ts, _, _, _ = sent.verdict(ts, loss, gnorm, finite, tcfg)


@pytest.mark.parametrize("n", [4, 7, 32])
def test_ring_quantile_matches_jnp(n):
    rng = np.random.default_rng(n)
    for q in (0.5, 0.9, 0.95):
        ring = (rng.random(n) * 3).astype(np.float32)
        want = np.asarray(jax.jit(lambda r: jnp.quantile(r, q))(jnp.asarray(ring)))
        got = sent.ring_quantile(torch.from_numpy(ring), q).numpy()
        assert got.view(np.uint32) == want.view(np.uint32), (q, got, want)


def test_batch_fingerprint_matches_jax():
    rng = np.random.default_rng(0)
    batches = [chaos.batch_for(i) for i in range(3)]
    batches.append({"labels": rng.integers(-100, 50, (2, 5)).astype(np.int64),
                    "input_ids": rng.integers(0, 50, (2, 5)).astype(np.int32),
                    "mask": rng.random((2, 5)).astype(np.float32)})
    for b in batches:
        assert sent.batch_fingerprint(b) == jax_sent.batch_fingerprint(b)
    # a tensor batch names the same batch
    t = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    assert sent.batch_fingerprint(t) == jax_sent.batch_fingerprint(batches[0])


def test_quarantine_and_heartbeat_files_cross(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    sent.save_quarantine(a, ["f2", "f1", "f2"])
    assert jax_sent.load_quarantine(a) == ["f1", "f2"]
    jax_sent.save_quarantine(b, ["x"])
    assert sent.load_quarantine(b) == ["x"]
    with open(sent.quarantine_path(b), "w") as f:
        f.write("{torn")
    assert sent.load_quarantine(b) == [] == jax_sent.load_quarantine(b)
    sent.Heartbeat(a, rank=0, interval_s=0.0).beat(3)
    jax_sent.Heartbeat(a, rank=1, interval_s=0.0).beat(4)
    ages_j, ages_t = jax_agent.beacon_ages(a), agent.beacon_ages(a)
    assert set(ages_j) == set(ages_t) == {0, 1}
    assert all(0 <= v < 60 for v in ages_t.values())
    assert sent.heartbeat_path(a, "0_s1") == jax_sent.heartbeat_path(a, "0_s1")


def test_policy_actions_match_jax(tmp_path):
    cfg = {"enabled": True, "window_steps": 5, "max_wedges": 2,
           "on_third_strike": "reduce-lr"}
    pols = []
    for load, mod, sub in ((jax_load_config, jax_sent, "j"), (load_config, sent, "t")):
        c = load({"sentinel": {**cfg, "state_dir": str(tmp_path / sub)}}).sentinel
        pols.append((mod.SentinelPolicy(c), []))
    calls = [("observe", 1, ["a"], "t1"), ("tick",), ("observe", 2, ["b", "a"], "t2"),
             ("observe", 4, ["c"], None)] + [("tick",)] * 6 + [
        ("observe", 1, ["d"], "t3"), ("wedge",), ("wedge",), ("observe", 8, [""], "t4")]
    for pol, log in pols:
        for c in calls:
            if c[0] == "tick":
                pol.tick()
            elif c[0] == "wedge":
                log.append(pol.observe_wedge())
            else:
                log.append(pol.observe(c[1], c[2], latest_tag=c[3]))
            log.append((pol.rollback_tag, pol.strikes_in_window, list(pol.quarantined)))
    assert pols[0][1] == pols[1][1]
    assert sent.load_quarantine(str(tmp_path / "t")) == ["a", "b", "c", "d"]


# ------------------------------------------------------ self-healing run
def _np_params():
    from deepspeed_tpu.models import llama as jax_llama

    c = chaos.model_config()
    jcfg = jax_llama.LlamaConfig(**{k: getattr(c, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
        "num_kv_heads", "max_seq_len")})
    return jcfg, jax.tree_util.tree_map(np.array,
                                        jax_llama.init_params(jcfg, jax.random.PRNGKey(5)))


def _faults():
    fp = sent.batch_fingerprint(chaos.batch_for(10))
    return [{"point": "train.grads", "kind": "nan-grads", "after": 6, "times": 1},
            {"point": "data.batch", "kind": "poison-batch", "request_id": fp, "times": 1}]


def _jax_run(work, np_params, jcfg, faults):
    """The chaos worker's loop on the JAX engine (``bench.py:2347``)."""
    import deepspeed_tpu
    from deepspeed_tpu.comm.topology import reset_topology
    from deepspeed_tpu.models import llama as jax_llama
    from deepspeed_tpu.serving import faults as jax_faults

    reset_topology()

    def factory(skip):
        def gen():
            i = skip
            while True:
                yield chaos.batch_for(i)
                i += 1
        return gen()

    eng, _, _, _ = deepspeed_tpu.initialize(
        model=lambda ctx: jax_llama.build(jcfg, ctx=ctx),
        config={**chaos.train_config(work, True), **FP32},
        training_data=jax_dl.CheckpointableLoader(factory), seed=5,
        initial_params=np_params, mesh_devices=jax.devices()[:1])
    inj = jax_faults.get_fault_injector()
    inj.configure(faults)
    traj, rollbacks = {}, 0
    try:
        while eng.global_steps < chaos.SENT_TOTAL:
            step = eng.global_steps
            loss = eng.train_batch()
            if eng.global_steps <= step:
                rollbacks += 1
                continue
            traj[step] = float(np.asarray(loss))
            if eng.global_steps % chaos.SENT_SAVE == 0:
                eng.save_checkpoint(os.path.join(work, "ckpt"))
        eng.destroy()
    finally:
        inj.reset()
    return traj, rollbacks, sorted(eng._sentinel.quarantined)


def _self_heal_runs():
    import tempfile

    jcfg, np_params = _np_params()
    root = tempfile.mkdtemp(prefix="dstpu-selfheal-")
    try:
        out = {"jax": _jax_run(os.path.join(root, "jax"), np_params, jcfg, _faults())}
        for name, faults in (("chaos", _faults()), ("clean", None)):
            work = os.path.join(root, name)
            if faults is None:  # the clean run skips what the chaos run quarantined
                sent.save_quarantine(os.path.join(work, "state"),
                                     sent.load_quarantine(os.path.join(root, "chaos", "state")))
            rc = chaos.run_worker(work, total_steps=chaos.SENT_TOTAL,
                                  save_every=chaos.SENT_SAVE, faults=faults, sentinel=True,
                                  device="cpu", initial_params=np_params, overrides=FP32)
            status = chaos.read_jsonl(os.path.join(work, "status.jsonl"))
            out[name] = dict(
                rc=rc, rollbacks=sum(s["event"] == "rollback" for s in status),
                traj={r["step"]: r["loss"]
                      for r in chaos.read_jsonl(os.path.join(work, "trajectory.jsonl"))},
                quarantine=sent.load_quarantine(os.path.join(work, "state")),
                reports=sorted(os.listdir(os.path.join(work, "reports")))
                if os.path.isdir(os.path.join(work, "reports")) else [])
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_self_healing_run_matches_jax_and_its_clean_run():
    """One quarantine (nan-grads at the 7th step), one rollback (the poisoned
    batch 10, a loss spike) and the replay: the stitched losses equal the
    JAX engine's same run (rtol 1e-5) and the port's clean run with the
    quarantine pre-seeded, bit for bit."""
    r = shared(_self_heal_runs)
    jtraj, jrollbacks, jquar = r["jax"]
    chaos_run, clean = r["chaos"], r["clean"]
    assert chaos_run["rc"] == clean["rc"] == 0
    assert chaos_run["rollbacks"] == jrollbacks == 1 and clean["rollbacks"] == 0
    assert chaos_run["quarantine"] == jquar and len(jquar) == 2
    assert any(n.startswith("sentinel_rollback") for n in chaos_run["reports"])
    assert set(chaos_run["traj"]) == set(range(chaos.SENT_TOTAL))
    steps = range(chaos.SENT_TOTAL)
    np.testing.assert_allclose([chaos_run["traj"][s] for s in steps],
                               [jtraj[s] for s in steps], rtol=1e-5)
    assert [chaos_run["traj"][s] for s in steps] == [clean["traj"][s] for s in steps]


# ------------------------------------------------------------ loaders
def _factory(skip):
    def gen():
        i = skip
        while True:
            yield chaos.batch_for(i)
            i += 1
    return gen()


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpointable_loader_state_crosses(direction):
    src_mod, dst_mod = (dl, jax_dl) if direction == "port_to_jax" else (jax_dl, dl)
    src = src_mod.CheckpointableLoader(_factory)
    src.quarantine([jax_sent.batch_fingerprint(chaos.batch_for(4))])
    got = [next(src) for _ in range(5)]  # batches 0-3, then 5 (4 is skipped)
    _same(got[4], chaos.batch_for(5))
    state = src.state_dict()
    assert state == {"batches_consumed": 6, "quarantine": src.quarantined}
    dst = dst_mod.CheckpointableLoader(_factory)
    dst.load_state_dict(state)
    _same(next(dst), next(src))
    assert dst.state_dict() == src.state_dict()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_repeating_loader_state_crosses(direction):
    src_mod, dst_mod = (dl, jax_dl) if direction == "port_to_jax" else (jax_dl, dl)
    data = [chaos.batch_for(i) for i in range(3)]
    src = src_mod.RepeatingLoader(data)
    src.quarantine([sent.batch_fingerprint(data[1])])
    for _ in range(4):
        next(src)
    dst = dst_mod.RepeatingLoader(data)
    dst.load_state_dict(src.state_dict())
    assert dst.state_dict() == src.state_dict()
    skipped = src.quarantined_skipped
    for _ in range(3):
        _same(next(dst), next(src))
    assert dst.quarantined_skipped == src.quarantined_skipped - skipped == 1


def test_array_and_token_loaders_match_jax():
    rng = np.random.default_rng(1)
    arrays = {"x": rng.random((10, 3)).astype(np.float32), "y": np.arange(10)}
    for kw in ({}, {"shuffle": False, "drop_last": False}):
        a, b = dl.array_loader(arrays, 4, seed=2, **kw), jax_dl.array_loader(arrays, 4, seed=2,
                                                                           **kw)
        for x, y in itertools.islice(zip(a, b), 7):  # past an epoch (2 a epoch)
            _same(x, y)
    a, b = dl.random_token_loader(2, 5, 50, seed=3), jax_dl.random_token_loader(2, 5, 50, seed=3)
    for _ in range(3):
        _same(next(a), next(b))
