"""Elastic agent: worker supervision and scale-adaptive restart
(counterpart of ``deepspeed_tpu/elasticity/agent.py``).

The agent starts the training worker processes, polls them, and on a
worker's death (eviction, preemption, crash) recomputes an admissible world
size from the surviving slots (``elasticity.get_compatible_world_sizes``)
and relaunches; the workers resume from the newest verified checkpoint,
which loads at any world size. A live worker whose heartbeat beacon
(``runtime/sentinel.Heartbeat``) goes stale is SIGKILLed and the world
restarts. The agent only supervises processes: it never runs training
itself, so nothing moves off the workers' device.

``PreemptionHandler`` gives a training loop the SIGTERM-checkpoint
behaviour a preemption notice needs, and lets the serving tier
(``serving/frontend.py install_preemption_handler``) register drain hooks
on the same signal path.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from deepspeed_tpu_torch.elasticity.elasticity import get_compatible_world_sizes
from deepspeed_tpu_torch.utils.logging import log_dist


def beacon_ages(heartbeat_dir: str | None,
                now: float | None = None) -> dict[int, float]:
    """Per-rank heartbeat beacon ages (seconds since the freshest write),
    taking the WORST of the rank beacon and any per-stage beacons
    (``heartbeat_{rank}_s{t}.json``) — the same staleness verdict the
    agent's kill decision uses. Ranks with no beacon yet are absent."""
    ages: dict[int, float] = {}
    if not heartbeat_dir or not os.path.isdir(heartbeat_dir):
        return ages
    wall = time.time() if now is None else float(now)
    for path in glob.glob(os.path.join(heartbeat_dir, "heartbeat_*.json")):
        stem = os.path.basename(path)[len("heartbeat_"):-len(".json")]
        try:
            rank = int(stem.split("_s")[0])
        except ValueError:
            continue
        try:
            age = wall - os.path.getmtime(path)
        except OSError:
            continue  # beacon swept between glob and stat
        if rank not in ages or age > ages[rank]:
            ages[rank] = age
    return ages


def publish_heartbeat_ages(heartbeat_dir: str | None,
                           telemetry=None) -> dict[int, float]:
    """Surface beacon ages as ``worker_heartbeat_age_seconds{rank=}``
    gauges (no-op while telemetry is disabled) and return them. The fleet
    aggregator's ``/debug/fleet`` rollup reads these series."""
    if telemetry is None:
        from deepspeed_tpu_torch.telemetry import get_telemetry

        telemetry = get_telemetry()
    ages = beacon_ages(heartbeat_dir)
    if telemetry.enabled and ages:
        g = telemetry.gauge(
            "worker_heartbeat_age_seconds",
            "seconds since each worker rank's freshest heartbeat beacon "
            "(worst of the rank and per-stage beacons)")
        for rank, age in ages.items():
            g.set(age, rank=rank)
    return ages


@dataclass
class WorkerSpec:
    """One supervised worker process."""

    cmd: Sequence[str]
    env: dict | None = None
    proc: subprocess.Popen | None = None
    restarts: int = 0


@dataclass
class ElasticAgent:
    """Supervise worker processes; restart at an admissible world size.

    ``target_batch_size`` + ``micro_batch_candidates`` define the admissible
    world sizes (the elasticity v0.1/0.2 math); the agent only ever
    runs a worker count from that set, so every restart preserves the batch
    triangle exactly.
    """

    target_batch_size: int
    micro_batch_candidates: Sequence[int]
    make_worker: Callable[[int, int], WorkerSpec]  # (rank, world) -> spec
    max_world_size: int
    min_world_size: int = 1
    poll_interval: float = 1.0
    max_restarts: int = 3
    on_scale_change: Callable[[int], None] | None = None
    workers: list = field(default_factory=list)
    # liveness (runtime/sentinel.py heartbeat protocol): workers write
    # heartbeat_{rank}.json into heartbeat_dir at step boundaries; a live
    # process whose beacon goes stale past heartbeat_timeout is wedged —
    # SIGKILL it and restart the world. 0 disables the check. The grace
    # window covers start-up (imports, the kernels' load, the first step).
    heartbeat_dir: str | None = None
    heartbeat_timeout: float = 0.0
    heartbeat_grace: float = 30.0

    def admissible_world_sizes(self) -> list[int]:
        sizes = get_compatible_world_sizes(
            self.target_batch_size, list(self.micro_batch_candidates),
            self.min_world_size, self.max_world_size,
        )
        if not sizes:
            raise ValueError(
                f"no admissible world size in [{self.min_world_size}, "
                f"{self.max_world_size}] for batch {self.target_batch_size} "
                f"and micro-batches {list(self.micro_batch_candidates)}"
            )
        return sizes

    def _sweep_stale_state(self) -> None:
        """Remove sentinel state a killed worker left behind. Heartbeat
        beacons are per-incarnation liveness — a stale one from a SIGKILL'd
        predecessor would either mask a wedge or trigger an instant false
        kill, so they are always removed. The quarantine list is healing
        MEMORY and is kept — unless it is torn/unparseable (a worker died
        mid-write before the atomic-rename writer existed), in which case a
        fresh start beats honoring garbage."""
        d = self.heartbeat_dir
        if not d or not os.path.isdir(d):
            return
        for name in os.listdir(d):
            path = os.path.join(d, name)
            if name.startswith("heartbeat_"):
                try:
                    os.remove(path)
                except OSError:
                    pass
            elif name == "quarantine.json":
                try:
                    with open(path) as f:
                        if not isinstance(json.load(f), list):
                            raise ValueError("not a list")
                except (OSError, ValueError):
                    try:
                        os.remove(path)
                        log_dist("elastic agent: removed torn quarantine "
                                 "file", ranks=[0])
                    except OSError:
                        pass

    def _launch(self, world: int) -> None:
        self._sweep_stale_state()
        self.workers = []
        self._launch_time = time.monotonic()
        for rank in range(world):
            spec = self.make_worker(rank, world)
            spec.proc = subprocess.Popen(
                list(spec.cmd), env=spec.env,
                stdout=subprocess.DEVNULL if rank else None,
                stderr=subprocess.DEVNULL if rank else None,
            )
            self.workers.append(spec)
        log_dist(f"elastic agent: launched {world} workers", ranks=[0])

    def _stale_workers(self) -> list[int]:
        """Ranks whose process is alive but whose heartbeat beacon is older
        than the deadline (wedged-but-alive: a hung collective, a stuck
        device program — the one failure mode ``proc.poll()`` cannot see)."""
        if not self.heartbeat_dir or self.heartbeat_timeout <= 0:
            return []
        now = time.monotonic()
        wall = time.time()
        stale = []
        for rank, w in enumerate(self.workers):
            if w.proc.poll() is not None:
                continue
            # the rank beacon plus any per-pipeline-stage beacons
            # (heartbeat_{rank}_s{t}.json, one per MPMD stage thread): the
            # staleness verdict is the WORST of them, so a single wedged
            # stage flags the worker even while the step-boundary rank
            # beacon keeps beating
            paths = [os.path.join(self.heartbeat_dir,
                                  f"heartbeat_{rank}.json")]
            paths.extend(sorted(glob.glob(os.path.join(
                self.heartbeat_dir, f"heartbeat_{rank}_s*.json"))))
            ages = []
            for path in paths:
                try:
                    ages.append(wall - os.path.getmtime(path))
                except OSError:
                    # no beacon yet: only the grace window applies
                    ages.append(None)
            age = (None if any(a is None for a in ages)
                   else max(ages))
            in_grace = now - self._launch_time < max(
                self.heartbeat_grace, self.heartbeat_timeout)
            if in_grace:
                continue
            if age is None or age > self.heartbeat_timeout:
                stale.append(rank)
        return stale

    def heartbeat_ages(self) -> dict[int, float]:
        """Current per-rank beacon ages, published as
        ``worker_heartbeat_age_seconds{rank=}`` gauges (the fleet rollup's
        liveness input). Empty when no heartbeat_dir is configured."""
        return publish_heartbeat_ages(self.heartbeat_dir)

    def run(self) -> int:
        """Supervision loop: launch at the
        largest admissible world size; on any worker death — a nonzero exit,
        a SIGKILL'd preemption (negative returncode), a crashed host — stop
        the rest and relaunch at the largest size admissible with one fewer
        worker slot. The relaunched workers resume from the newest verified
        checkpoint (``load_checkpoint`` walks the fallback ladder, so even a
        worker killed mid-checkpoint-commit restarts clean). Returns 0 when
        all workers exit cleanly. ``self.restarts`` / ``self.world_size``
        record what supervision did, for harness assertions."""
        world = self.admissible_world_sizes()[-1]
        self.restarts = 0
        self.world_size = world
        self.heartbeat_kills = 0
        self._launch(world)
        while True:
            time.sleep(self.poll_interval)
            if self.heartbeat_dir:
                self.heartbeat_ages()
            for rank in self._stale_workers():
                # wedged-but-alive: poll() sees nothing wrong, the beacon
                # does. SIGKILL (a stuck device program ignores SIGTERM)
                # and let the death branch below run the normal restart.
                w = self.workers[rank]
                log_dist(
                    f"elastic agent: worker {rank} heartbeat stale "
                    f"(> {self.heartbeat_timeout:.0f}s); killing", ranks=[0])
                self.heartbeat_kills += 1
                try:
                    w.proc.kill()
                    w.proc.wait(timeout=30)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            codes = [w.proc.poll() for w in self.workers]
            if all(c == 0 for c in codes):
                log_dist("elastic agent: all workers finished", ranks=[0])
                return 0
            if any(c not in (None, 0) for c in codes):
                dead = [i for i, c in enumerate(codes) if c not in (None, 0)]
                log_dist(
                    f"elastic agent: workers {dead} died "
                    f"(codes {[codes[i] for i in dead]})", ranks=[0],
                )
                for w in self.workers:
                    if w.proc.poll() is None:
                        w.proc.terminate()
                for w in self.workers:
                    try:
                        w.proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        w.proc.kill()
                self.restarts += 1
                from deepspeed_tpu_torch.telemetry import get_telemetry

                tel = get_telemetry()
                if tel.enabled:
                    tel.counter(
                        "elastic_restarts_total",
                        "world restarts the elastic agent performed").inc()
                    tel.gauge(
                        "elastic_world_size",
                        "worker count of the supervised world"
                    ).set(self.world_size)
                if self.restarts > self.max_restarts:
                    log_dist("elastic agent: restart budget exhausted", ranks=[0])
                    return 1
                # scale down: CAPACITY shrinks by the dead workers (spare
                # slots above the launched world size remain usable)
                self.max_world_size = max(
                    self.min_world_size, self.max_world_size - len(dead))
                try:
                    world = self.admissible_world_sizes()[-1]
                except ValueError:
                    log_dist("elastic agent: no admissible world size left",
                             ranks=[0])
                    return 1
                if self.on_scale_change is not None:
                    self.on_scale_change(world)
                self.world_size = world
                self._launch(world)


class PreemptionHandler:
    """SIGTERM-triggered graceful-stop hook (a preemption notice) shared by
    the training and serving tiers.

    One signal path, two registration styles:

    - **training** (legacy contract): ``PreemptionHandler(engine, save_dir)``
      registers a ``checkpoint`` callback; poll ``should_stop`` at step
      boundaries and ``checkpoint_if_needed()`` writes at most one
      checkpoint on the way out.
    - **serving / anything else**: ``register(name, fn, immediate=...)``
      adds arbitrary stop hooks. ``immediate=True`` callbacks run inside the
      signal handler itself and must be non-blocking (e.g. "stop admitting
      requests" — flag flips only); the rest run via ``drain()`` at a safe
      boundary. Every callback runs at most once per preemption.

    ``stop_event`` is a ``threading.Event`` set on the signal, so background
    loops (the serving engine loop, a checkpoint writer) can wait on it
    instead of polling ``should_stop``.
    """

    def __init__(self, engine=None, save_dir: str | None = None,
                 signals=(signal.SIGTERM,)):
        if engine is not None and save_dir is None:
            raise ValueError("save_dir is required when an engine is given")
        self.engine = engine
        self.save_dir = save_dir
        self.should_stop = False
        self.stop_event = threading.Event()
        self._callbacks: list[tuple[str, Callable[[], object], bool]] = []
        self._ran: dict[str, object] = {}
        self._prev = {}
        if engine is not None:
            self.register("checkpoint", self._checkpoint)
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)

    def register(self, name: str, fn: Callable[[], object],
                 immediate: bool = False) -> Callable[[], object]:
        """Add a stop hook. ``immediate`` hooks fire inside the signal
        handler (keep them to flag flips / Event sets); deferred hooks run
        from ``drain()``/``checkpoint_if_needed()`` at a step boundary."""
        if any(n == name for n, _, _ in self._callbacks):
            raise ValueError(f"preemption callback {name!r} already registered")
        self._callbacks.append((name, fn, immediate))
        return fn

    def _checkpoint(self):
        """Write the one preempt checkpoint and JOIN any async flush before
        returning: the process is about to exit, and a writer-thread error
        surfaced here is the last chance to see it (a silently dropped flush
        error would leave ``latest`` pointing at the previous checkpoint
        while the operator believes the preempt save landed)."""
        path = self.engine.save_checkpoint(self.save_dir, tag="preempt")
        join = getattr(self.engine, "_join_ckpt_writer", None)
        if join is not None:
            join()  # raises if the async flush failed; do not swallow
        return path

    def _on_signal(self, signum, frame):
        del frame
        log_dist(f"preemption notice (signal {signum}): stop + drain",
                 ranks=[0])
        self.should_stop = True
        self.stop_event.set()
        for name, fn, immediate in self._callbacks:
            if immediate and name not in self._ran:
                self._ran[name] = None
                try:
                    self._ran[name] = fn()
                except Exception as e:  # a failing hook must not mask the signal
                    log_dist(f"preemption hook {name!r} failed: {e!r}",
                             ranks=[0])

    def _run_once(self, name: str, fn: Callable[[], object]):
        if name not in self._ran:
            self._ran[name] = fn()
        return self._ran[name]

    def drain(self) -> dict:
        """Run every registered callback not already fired, each at most
        once; call at a safe boundary after ``should_stop``. Returns
        ``{name: result}`` for everything that has run."""
        if not self.should_stop:
            return {}
        for name, fn, _ in self._callbacks:
            self._run_once(name, fn)
        return dict(self._ran)

    def checkpoint_if_needed(self) -> str | None:
        """Legacy training contract: at most one preempt checkpoint, written
        at the step boundary once ``should_stop`` is set."""
        if not self.should_stop or self.engine is None:
            return None
        if "checkpoint" in self._ran:
            return None
        return self._run_once("checkpoint", self._checkpoint)

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def main(argv: list[str] | None = None) -> int:  # pragma: no cover - CLI
    """Tiny CLI: ``python -m deepspeed_tpu_torch.elasticity.agent -- <worker cmd>``
    supervises N copies of the worker command with RANK/WORLD_SIZE env."""
    import argparse
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--target-batch-size", type=int, required=True)
    p.add_argument("--micro-batches", type=int, nargs="+", required=True)
    p.add_argument("--max-world-size", type=int, required=True)
    p.add_argument("--min-world-size", type=int, default=1)
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]

    def make(rank, world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world))
        return WorkerSpec(cmd=cmd, env=env)

    agent = ElasticAgent(
        target_batch_size=args.target_batch_size,
        micro_batch_candidates=args.micro_batches,
        make_worker=make,
        max_world_size=args.max_world_size,
        min_world_size=args.min_world_size,
    )
    return agent.run()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
