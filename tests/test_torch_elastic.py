"""The elastic agent, the preemption handler and kill-and-resume, on the CPU.

- world-size math (``get_compatible_world_sizes``, ``compute_elastic_config``)
  and ``ElasticAgent.admissible_world_sizes`` against the JAX package's;
- the agent supervising ``python -c`` workers that import nothing: a slot
  that dies shrinks the world from 2 to 1 and the rest finish; a live worker
  whose heartbeat goes stale is SIGKILLed and its relaunch finishes;
- ``PreemptionHandler``: SIGTERM to this process sets the stop flag and the
  event, runs the immediate hooks at once and the others at ``drain()``,
  and ``checkpoint_if_needed`` writes one ``preempt`` tag that verifies;
- one kill-and-resume: the chaos worker (``runtime/chaos.py``) as a process,
  SIGKILLed at ``ckpt.commit``, then a process that resumes from the
  newest verified checkpoint; the stitched trajectory equals the
  uninterrupted in-process run's bit for bit (two worker processes).
"""

import json
import os
import signal
import subprocess
import sys
import time
from functools import partial

import pytest

from deepspeed_tpu.elasticity import agent as jax_agent
from deepspeed_tpu.elasticity import elasticity as jax_el
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.elasticity import agent, elasticity
from deepspeed_tpu_torch.runtime import chaos
from torch_serving_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("batch,micros,lo,hi", [(4, [2, 4], 1, 2), (96, [1, 2, 3, 8], 1, 16),
                                                (100, [3, 7], 2, 9), (64, [4], 3, 12)])
def test_world_sizes_match_jax(batch, micros, lo, hi):
    assert (elasticity.get_compatible_world_sizes(batch, micros, lo, hi)
            == jax_el.get_compatible_world_sizes(batch, micros, lo, hi))
    try:
        want = jax_el.compute_elastic_config(batch, micros, hi, lo)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            elasticity.compute_elastic_config(batch, micros, hi, lo)
    else:
        assert elasticity.compute_elastic_config(batch, micros, hi, lo).__dict__ == want.__dict__
    kw = dict(target_batch_size=batch, micro_batch_candidates=micros, max_world_size=hi,
              min_world_size=lo, make_worker=None)
    try:
        want = jax_agent.ElasticAgent(**kw).admissible_world_sizes()
    except ValueError:
        with pytest.raises(ValueError, match="no admissible world size"):
            agent.ElasticAgent(**kw).admissible_world_sizes()
    else:
        assert agent.ElasticAgent(**kw).admissible_world_sizes() == want


def _py(code):
    return [sys.executable, "-c", code]


def test_agent_shrinks_the_world_when_a_slot_dies(tmp_path):
    done = tmp_path / "done"

    def make(rank, world):
        if rank == 1:
            return agent.WorkerSpec(cmd=_py("import sys, time; time.sleep(0.3); sys.exit(3)"))
        return agent.WorkerSpec(cmd=_py(
            f"import time; time.sleep(0.6); open({str(done)!r} + '{world}', 'w').close()"))

    a = agent.ElasticAgent(target_batch_size=4, micro_batch_candidates=[2, 4], make_worker=make,
                           max_world_size=2, poll_interval=0.1, max_restarts=3)
    assert a.run() == 0
    assert (a.world_size, a.restarts) == (1, 1)
    assert (tmp_path / "done1").exists()


def test_agent_kills_a_worker_whose_heartbeat_goes_stale(tmp_path):
    hb = tmp_path / "state"
    beat = (f"import json, os; os.makedirs({str(hb)!r}, exist_ok=True); "
            f"json.dump({{'step': 1}}, open({str(hb / 'heartbeat_0.json')!r}, 'w'))")
    incarnations = []

    def make(rank, world):
        incarnations.append(rank)
        tail = "; import time; time.sleep(60)" if len(incarnations) == 1 else ""
        return agent.WorkerSpec(cmd=_py(beat + tail))

    a = agent.ElasticAgent(target_batch_size=4, micro_batch_candidates=[4], make_worker=make,
                           max_world_size=1, poll_interval=0.1, max_restarts=2,
                           heartbeat_dir=str(hb), heartbeat_timeout=1.0, heartbeat_grace=0.5)
    t0 = time.monotonic()
    assert a.run() == 0
    assert (a.heartbeat_kills, a.restarts, len(incarnations)) == (1, 1, 2)
    assert time.monotonic() - t0 < 30
    assert set(agent.beacon_ages(str(hb))) == {0}


def test_preemption_handler_training_and_hooks(tmp_path):
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.engine import initialize

    eng, _, _, _ = initialize(model=partial(llama.build, chaos.model_config()),
                              config=chaos.train_config(str(tmp_path), False), device="cpu")
    eng.train_batch(chaos.batch_for(0))
    h = agent.PreemptionHandler(eng, str(tmp_path / "ckpt"))
    ran = []
    h.register("flag", lambda: ran.append("flag"), immediate=True)
    h.register("later", lambda: ran.append("later") or "ok")
    try:
        assert h.checkpoint_if_needed() is None and h.drain() == {}
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.stop_event.wait(5) and h.should_stop and ran == ["flag"]
        path = h.checkpoint_if_needed()
        assert path.endswith("preempt") and h.checkpoint_if_needed() is None
        assert ckpt.verify_checkpoint(path)["global_steps"] == 1
        assert h.drain() == {"flag": None, "later": "ok", "checkpoint": path}
        assert ran == ["flag", "later"]
        with pytest.raises(ValueError, match="already registered"):
            h.register("flag", lambda: None)
    finally:
        h.restore()


def test_kill_at_commit_then_resume_is_the_uninterrupted_run(tmp_path):
    ref = tmp_path / "ref"
    assert chaos.run_worker(str(ref), device="cpu") == 0
    want = {r["step"]: r["loss"] for r in chaos.read_jsonl(str(ref / "trajectory.jsonl"))}
    work = tmp_path / "chaos"
    env = dict(os.environ, PYTHONPATH=REPO, CHAOS_DIR=str(work), CHAOS_DEVICE="cpu",
               CHAOS_FAULTS=json.dumps([{"point": "ckpt.commit", "kind": "kill", "after": 1}]))
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.runtime.chaos"]
    killed = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    env["CHAOS_FAULTS"] = "[]"
    resumed = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                             timeout=300)
    assert resumed.returncode == 0 and "CHAOS_WORKER_DONE" in resumed.stdout, resumed.stderr
    status = chaos.read_jsonl(str(work / "status.jsonl"))
    resume = [s for s in status if s["event"] == "resume"]
    # the kill hit the second save's commit: the first save's tag is the newest
    assert [s["tag"] for s in resume] == ["global_step2"]
    assert not any(n.startswith(".tmp-") and n != ".tmp-global_step4"
                   for n in os.listdir(work / "ckpt"))
    got: dict = {}
    for r in chaos.read_jsonl(str(work / "trajectory.jsonl")):
        assert r["loss"] == want[r["step"]]  # the replayed steps too, bit for bit
        got[r["step"]] = r["loss"]
    assert got == want and len(want) == 10
    assert chaos.recoveries(str(work))[0]["seconds_to_first_step"] > 0
