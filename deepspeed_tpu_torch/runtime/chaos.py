"""Kill-and-resume chaos harness of the training path (counterpart of
``bench.py``'s ``train_chaos_worker_main`` and ``_train_chaos_impl``).

The worker (:func:`run_worker`; a process: ``python -m
deepspeed_tpu_torch.runtime.chaos`` with the ``CHAOS_*`` environment)
trains a tiny Llama (hidden 32, 1 layer, vocabulary 97, 4 x 32 tokens) on
a deterministic stream (batch ``i`` is a function of ``i`` through
``CheckpointableLoader``), saves every ``save_every`` steps and, on start,
resumes from the newest verified checkpoint. Armed faults arrive as JSON,
``kill`` kinds among them, which SIGKILL the worker at a checkpoint seam.
Every trained step's loss is appended, fsynced, to ``trajectory.jsonl``
and lifecycle events to ``status.jsonl``, each with its wall time.

``chip_smoke.py`` runs the reference's legs with this worker (all but the
pipeline leg: ROADMAP.md queue 1 item 12), and :func:`recoveries` reads
each restart's seconds to its first new step from a work dir. The workers
run on the card (``device`` None) and fail when there is none: nothing
moves to the CPU unless asked.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_PROCESS_START = time.time()  # a worker's launch, for the time to recover
BATCH, SEQ, VOCAB = 4, 32, 97
# the legs' worker runs (bench.py:2347-2880): the reference and kill legs,
# the sentinel leg and the wedge leg; steps and the save interval
TOTAL_STEPS = 10        # save every 2
SENT_TOTAL, SENT_SAVE = 16, 3
WEDGE_TOTAL, WEDGE_SAVE = 8, 2


def model_config():
    from deepspeed_tpu_torch.models import llama

    return llama.LlamaConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                             num_layers=1, num_heads=4, num_kv_heads=2, max_seq_len=SEQ)


def batch_for(i: int) -> dict:
    rng = np.random.default_rng(777 + i)
    return {"input_ids": rng.integers(0, VOCAB, (BATCH, SEQ), dtype=np.int32)}


def train_config(work_dir: str, sentinel: bool) -> dict:
    """``bench.py``'s worker config (``:2397-2423``)."""
    config = {
        "train_batch_size": BATCH, "gradient_accumulation_steps": 1, "sequence_length": SEQ,
        "steps_per_print": 0, "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 0}, "mesh": {"data": -1},
        "checkpoint": {"keep_n_latest": 3}, "seed": 5,
    }
    if sentinel:
        config["sentinel"] = {"enabled": True, "warmup_steps": 3,
                              "report_dir": os.path.join(work_dir, "reports"),
                              "state_dir": os.path.join(work_dir, "state"),
                              "checkpoint_dir": os.path.join(work_dir, "ckpt")}
    return config


def append_event(path: str, obj: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(obj) + "\n")
        f.flush()
        os.fsync(f.fileno())


def read_jsonl(path: str) -> list:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass  # a torn last line from a kill mid-append
    return out


def _loader():
    from deepspeed_tpu_torch.runtime.dataloader import CheckpointableLoader

    def factory(skip):
        def gen():
            i = skip
            while True:
                yield batch_for(i)
                i += 1
        return gen()

    return CheckpointableLoader(factory)


def run_worker(work_dir: str, total_steps: int = 10, save_every: int = 2, faults=None,
               sentinel: bool = False, seed: int = 0, device=None,
               initial_params=None, overrides: dict | None = None) -> int:
    """The chaos worker's body (``bench.py:2347``), in this process: resume
    from the newest verified checkpoint under ``work_dir/ckpt``, train to
    ``total_steps``, save every ``save_every``. Returns the exit code (4
    when no checkpoint verifies). ``initial_params``: numpy weights instead
    of the seeded init; ``overrides``: config sections to replace."""
    from functools import partial

    from deepspeed_tpu_torch.checkpoint import engine as ckpt
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.engine import initialize
    from deepspeed_tpu_torch.serving import faults as faults_mod

    os.makedirs(work_dir, exist_ok=True)
    ckpt_dir = os.path.join(work_dir, "ckpt")
    status_path = os.path.join(work_dir, "status.jsonl")
    traj_path = os.path.join(work_dir, "trajectory.jsonl")
    engine, _, _, _ = initialize(model=partial(llama.build, model_config()),
                                 config={**train_config(work_dir, sentinel),
                                         **(overrides or {})},
                                 training_data=_loader(), seed=5, device=device,
                                 initial_params=initial_params)
    inj = faults_mod.get_fault_injector()
    try:
        # armed before the resume: corrupt-at-load models bit-rot found by
        # this run's own verification; kill specs at the save seams are
        # untouched by the load point's fires
        if faults:
            inj.configure(faults, seed=seed)
        latest_before = ckpt.latest_tag(ckpt_dir) if os.path.isdir(ckpt_dir) else None
        try:
            path, _ = engine.load_checkpoint(ckpt_dir)
        except ckpt.CheckpointCorruptError as ex:
            append_event(status_path, {"event": "exhausted", "stage": ex.stage})
            return 4
        append_event(status_path, {"event": "resume" if path else "fresh",
                                   "tag": os.path.basename(path) if path else None,
                                   "latest": latest_before, "step": engine.global_steps,
                                   "t": time.time(), "t_start": _PROCESS_START})
        while engine.global_steps < total_steps:
            step = engine.global_steps
            loss = engine.train_batch()
            if engine.global_steps <= step:
                # the sentinel rolled back; the replay logs every step again
                append_event(status_path, {"event": "rollback", "from": step,
                                           "to": engine.global_steps,
                                           "seconds": engine.last_rollback_s})
                continue
            append_event(traj_path, {"step": step, "loss": float(loss), "t": time.time()})
            if engine.global_steps % save_every == 0:
                engine.save_checkpoint(ckpt_dir)
                append_event(status_path, {"event": "saved",
                                           "tag": f"global_step{engine.global_steps}"})
        done = {"event": "done", "step": engine.global_steps}
        if engine._sentinel is not None:
            done["rollbacks"] = engine.train_rollbacks
            done["quarantined"] = engine._sentinel.quarantined
        engine.destroy()
        append_event(status_path, done)
        return 0
    finally:
        if faults:
            inj.reset()


def worker_main() -> int:
    """The worker as a process: ``CHAOS_DIR``, ``CHAOS_TOTAL_STEPS``,
    ``CHAOS_SAVE_EVERY``, ``CHAOS_SEED``, ``CHAOS_FAULTS`` (JSON),
    ``CHAOS_SENTINEL``, ``CHAOS_DEVICE`` (unset: the card). On the card it
    uses the flash libraries already built and fails without them."""
    e = os.environ
    device = e.get("CHAOS_DEVICE") or None
    if device is None or device.startswith("cuda"):
        from deepspeed_tpu_torch.ops.cuda import _build

        missing = [n for n in ("flash_fwd", "flash_bwd") if not _build.library_path(n).exists()]
        if missing:
            print(f"chaos worker: kernels not built: {missing}", file=sys.stderr)
            return 5
    import torch

    torch.set_num_threads(1)
    rc = run_worker(e["CHAOS_DIR"], total_steps=int(e.get("CHAOS_TOTAL_STEPS", 10)),
                    save_every=int(e.get("CHAOS_SAVE_EVERY", 2)),
                    faults=json.loads(e.get("CHAOS_FAULTS", "[]")),
                    sentinel=bool(e.get("CHAOS_SENTINEL")), seed=int(e.get("CHAOS_SEED", 0)),
                    device=device)
    if rc == 0:
        print("CHAOS_WORKER_DONE", flush=True)
    return rc


def recoveries(work_dir: str) -> list:
    """Each resume's seconds from its worker's launch to its first new step."""
    status = read_jsonl(os.path.join(work_dir, "status.jsonl"))
    traj = read_jsonl(os.path.join(work_dir, "trajectory.jsonl"))
    out = []
    for s in status:
        if s["event"] != "resume" or "t_start" not in s:
            continue
        first = [r["t"] for r in traj if r.get("t", 0) >= s["t"]]
        if first:
            out.append({"resumed_tag": s["tag"], "at_step": s["step"],
                        "seconds_to_first_step": min(first) - s["t_start"]})
    return out


if __name__ == "__main__":
    sys.exit(worker_main())
