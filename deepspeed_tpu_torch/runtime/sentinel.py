"""Self-healing training: divergence sentinel, quarantine, rollback ladder,
liveness (counterpart of ``deepspeed_tpu/runtime/sentinel.py``).

The training step already decides an overflow skip from one device flag
(``precision.grads_finite``). This module widens that flag into an
anomaly verdict computed on the device in the same step (a loss spike or a
grad-norm explosion takes the overflow's skip path) and adds the host side
that turns verdicts into recovery:

- :func:`verdict` — the anomaly decision over a rolling
  :class:`SentinelState` of 0-d / 1-d tensors (loss EMA + k·σ gate,
  grad-norm ring-quantile gate, consecutive-skip streak), updated with
  ``torch.where``. The engine reads the verdict in the step's one host
  sync, in place of the finite flag: detection adds no sync.
- :class:`SentinelPolicy` — the escalation ladder: strike 1 in the window
  quarantines the step's batch fingerprints and pins the rollback tag,
  strike 2 restores it and replays with the quarantined batches skipped,
  strike 3 reduces the learning rate or halts with a forensics JSON.
- :func:`batch_fingerprint` — the content hash naming a batch across runs
  and restarts; the loaders of ``runtime/dataloader.py`` skip it.
- :class:`Heartbeat` — a per-worker liveness file written at step
  boundaries from the training thread, polled by
  ``elasticity.agent.ElasticAgent``.
- :func:`watched_call` — the dispatch watchdog's deadline;
  :class:`TrainingWedgeError` when the fence exceeds it.

The file formats (quarantine list, heartbeat, forensics) and the
fingerprints are the JAX package's: either package reads the other's.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry import get_telemetry
from deepspeed_tpu_torch.utils.logging import log_dist

# Anomaly reason bitmask (a device int32; the host decodes it with reason_names)
REASON_NONFINITE = 1    # non-finite grads or loss (the overflow skip)
REASON_LOSS_SPIKE = 2   # loss > EMA + k*sigma
REASON_GRAD_SPIKE = 4   # grad norm > mult * rolling quantile
REASON_SKIP_STREAK = 8  # consecutive-skip streak crossed the threshold
REASON_WEDGE = 16       # host side: the dispatch fence exceeded the deadline

_REASON_LABELS = (
    (REASON_NONFINITE, "nonfinite"),
    (REASON_LOSS_SPIKE, "loss-spike"),
    (REASON_GRAD_SPIKE, "grad-spike"),
    (REASON_SKIP_STREAK, "skip-streak"),
    (REASON_WEDGE, "wedge"),
)

# The loss multiplier of the directive fault kinds (``train.grads`` /
# ``data.batch``): NaN models nan-grads; the finite factor a poisoned batch
# whose loss and gradients blow up together.
SPIKE_LOSS_MULT = 1.0e4


def reason_names(mask: int) -> list[str]:
    return [name for bit, name in _REASON_LABELS if mask & bit]


class DivergenceHaltError(RuntimeError):
    """Third strike: the run diverges faster than the ladder heals. Raised
    after the forensics JSON is written; ``report`` is its path."""

    def __init__(self, message: str, report: str | None = None):
        super().__init__(message)
        self.report = report


class TrainingWedgeError(TimeoutError):
    """The training dispatch fence exceeded the watchdog deadline. A
    ``TimeoutError``, so ``serving.faults.classify_transient`` counts it
    transient: the recovery is rollback or restart."""


# --------------------------------------------------------------- device side
class SentinelState(NamedTuple):
    """The rolling statistics on the training device (like
    ``precision.LossScaleState``: updated with ``torch.where``, never read
    on the host to decide anything)."""

    loss_ema: torch.Tensor     # f32 EMA of accepted-step loss
    loss_var: torch.Tensor     # f32 EMA of squared deviation from the EMA
    gnorm_ring: torch.Tensor   # f32[grad_window] last accepted grad norms
    ring_pos: torch.Tensor     # i32 next ring write slot
    seen: torch.Tensor         # i32 accepted steps folded into the stats
    skip_streak: torch.Tensor  # i32 consecutive anomalous steps


def init_state(cfg, device="cpu") -> SentinelState:
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return SentinelState(loss_ema=f32(0.0), loss_var=f32(0.0),
                         gnorm_ring=torch.zeros(int(cfg.grad_window), dtype=torch.float32,
                                                device=device),
                         ring_pos=i32(0), seen=i32(0), skip_streak=i32(0))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as XLA contracts it into a fused
    multiply-add in the JAX step: the fp32 product is exact in fp64."""
    return (a.double() * b.double() + c.double()).float()


def _const(x: float, device) -> torch.Tensor:
    """An fp32 0-d constant made on ``device`` by a fill: no copy from the
    host, so no wait for the device (``torch.tensor(x, device=...)`` copies
    from pageable host memory and syncs the stream)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _quantile_weights(q: float, n: int):
    """``jnp.quantile``'s linear interpolation indices and weights, in its
    fp32 arithmetic: position ``q * (n - 1)``, the weights ``pos - floor``
    and ``1 - that``."""
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    low = int(min(max(low, 0), n - 1))
    high = int(min(max(high, 0), n - 1))
    return low, high, lw, hw


def ring_quantile(ring: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(ring, q)`` (linear) as the JAX step computes it: the
    two sorted neighbours times their fp32 weights, summed (XLA fuses the
    low term's product into the add); NaN if the ring holds one."""
    low, high, lw, hw = _quantile_weights(q, ring.shape[0])
    s = torch.sort(ring).values
    out = _fma(s[low], _const(lw, ring.device), s[high] * _const(hw, ring.device))
    return torch.where(torch.isnan(ring).any(), _const(float("nan"), ring.device), out)


def verdict(state: SentinelState, loss, gnorm, finite, cfg):
    """The anomaly decision, on the device; the JAX package's ``verdict`` op
    for op in fp32, with XLA's fused multiply-adds where the JAX step has
    them (``_fma``), so the state's bits are the JAX step's.

    Returns ``(new_state, anomaly, reason, streak)``, all device scalars.
    The rolling stats take in only accepted steps (a spike folded into the
    EMA would mask the next one; a NaN would poison it). The streak counts
    consecutive anomalous steps and resets on an accepted one."""
    dev = loss.device

    def c(x):
        return _const(x, dev)

    loss = loss.float()
    gnorm = gnorm.float()
    nonfinite = torch.logical_or(torch.logical_not(finite),
                                 torch.logical_not(torch.isfinite(loss)))

    warm_loss = state.seen >= cfg.warmup_steps
    sigma = torch.sqrt(torch.maximum(state.loss_var, c(0.0)))
    # relative floor: early on the variance estimate is tiny and a purely
    # statistical gate would flag ordinary fluctuation
    sigma = torch.maximum(sigma, c(cfg.loss_rel_floor) * torch.abs(state.loss_ema))
    loss_spike = torch.logical_and(warm_loss,
                                   loss > _fma(c(cfg.loss_sigma_k), sigma, state.loss_ema))

    warm_gnorm = state.seen >= cfg.grad_window
    q = ring_quantile(state.gnorm_ring, cfg.grad_quantile)
    gnorm_spike = torch.logical_and(
        warm_gnorm, gnorm > c(cfg.grad_quantile_mult) * torch.maximum(q, c(1e-12)))

    anomaly = nonfinite | loss_spike | gnorm_spike
    i32 = torch.int32
    streak = torch.where(anomaly, state.skip_streak + 1, torch.zeros_like(state.skip_streak))
    reason = (nonfinite.to(i32) * REASON_NONFINITE
              + loss_spike.to(i32) * REASON_LOSS_SPIKE
              + gnorm_spike.to(i32) * REASON_GRAD_SPIKE
              + (streak >= cfg.max_consecutive_skips).to(i32) * REASON_SKIP_STREAK)

    ok = torch.logical_not(anomaly)
    beta = c(cfg.loss_ema_beta)
    one_minus = c(1.0) - beta
    first = state.seen == 0
    ema = torch.where(first, loss, _fma(beta, state.loss_ema, one_minus * loss))
    d = loss - ema
    var = torch.where(first, c(0.0), _fma(beta, state.loss_var, one_minus * d * d))
    # the ring slot by a mask, not an index: a 0-d index tensor is read on the host
    slot = torch.arange(state.gnorm_ring.shape[0], device=dev) == state.ring_pos
    ring = torch.where(torch.logical_and(slot, ok), gnorm, state.gnorm_ring)
    new_state = SentinelState(
        loss_ema=torch.where(ok, ema, state.loss_ema),
        loss_var=torch.where(ok, var, state.loss_var),
        gnorm_ring=ring,
        ring_pos=torch.where(ok, (state.ring_pos + 1) % cfg.grad_window, state.ring_pos),
        seen=state.seen + ok.to(i32),
        skip_streak=streak,
    )
    return new_state, anomaly, reason, streak


# ---------------------------------------------------------------- host side
def batch_fingerprint(batch: dict) -> str:
    """Content hash naming a batch across runs and restarts (key order does
    not matter): the JAX package's sha1 over each key, shape, dtype and
    bytes, so both packages name a batch alike."""
    h = hashlib.sha1()
    for k in sorted(batch):
        v = batch[k]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(str(v.dtype).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def quarantine_path(state_dir: str) -> str:
    return os.path.join(state_dir, "quarantine.json")


def load_quarantine(state_dir: str) -> list[str]:
    """The persisted quarantine list; a torn or garbage file reads as empty."""
    try:
        with open(quarantine_path(state_dir)) as f:
            data = json.load(f)
        if isinstance(data, list):
            return [str(x) for x in data]
    except (OSError, ValueError):
        pass
    return []


def save_quarantine(state_dir: str, fingerprints: list[str]) -> None:
    """Atomic persist (tmp + fsync + rename): a kill mid-write never leaves a
    torn list."""
    os.makedirs(state_dir, exist_ok=True)
    path = quarantine_path(state_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sorted(set(fingerprints)), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


_FORENSICS_LOCK = threading.Lock()
_FORENSICS_SEQ = 0


def write_forensics(report_dir: str, event: str, context: dict) -> str | None:
    """One self-contained report JSON per event, written before anything
    escalates. Never raises; returns the path (``None`` on failure)."""
    global _FORENSICS_SEQ
    try:
        with _FORENSICS_LOCK:
            _FORENSICS_SEQ += 1
            seq = _FORENSICS_SEQ
        report = {"type": "sentinel_report", "event": event, "ts": time.time(),
                  "pid": os.getpid(), **context}
        os.makedirs(report_dir, exist_ok=True)
        path = os.path.join(report_dir, f"sentinel_{event}_{os.getpid()}_{seq}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=str)
        tel = get_telemetry()
        if tel.enabled:
            tel.event("sentinel/" + event, report=path)
        return path
    except Exception:
        return None


class SentinelPolicy:
    """The host-side escalation ladder over settled verdicts.

    Strikes are counted on a monotonic tick (one per observed step, not
    ``global_steps``, which a rollback rewinds) and expire after
    ``window_steps`` ticks. Within one window: strike 1 quarantines the
    step's fingerprints and pins ``rollback_tag`` to the newest checkpoint;
    strike 2 quarantines and returns ``"rollback"``; strike 3 returns
    ``"reduce-lr"`` or ``"halt"`` per ``on_third_strike``. Wedges count
    apart (``observe_wedge``): each asks for a rollback at once, and
    ``max_wedges`` in the window halt."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.quarantined: list[str] = []
        self.rollback_tag: str | None = None
        self.rollbacks = 0
        self.lr_backoffs = 0
        self.anomalies = 0
        self.wedges = 0
        self._tick = 0
        self._strikes: list[int] = []
        self._wedge_ticks: list[int] = []
        if cfg.state_dir:
            self.quarantined = load_quarantine(cfg.state_dir)

    @property
    def strikes_in_window(self) -> int:
        return len([t for t in self._strikes if self._tick - t <= self.cfg.window_steps])

    def tick(self) -> None:
        """One accepted step observed."""
        self._tick += 1

    def observe(self, reason: int, fingerprints: list[str],
                latest_tag: str | None = None) -> str:
        """One anomalous step -> ``"quarantine" | "rollback" | "reduce-lr" |
        "halt"``."""
        self._tick += 1
        self.anomalies += 1
        w = self.cfg.window_steps
        self._strikes = [t for t in self._strikes if self._tick - t <= w]
        self._strikes.append(self._tick)
        self.quarantine(fingerprints)
        n = len(self._strikes)
        if n == 1:
            # the newest checkpoint predates this anomaly: replaying from it
            # rewrites every step the divergence touched
            self.rollback_tag = latest_tag
            return "quarantine"
        if n == 2 and self.cfg.rollback:
            return "rollback"
        return "reduce-lr" if self.cfg.on_third_strike == "reduce-lr" else "halt"

    def observe_wedge(self) -> str:
        """A dispatch-fence timeout -> ``"rollback"`` (at once: the step may
        never settle) or ``"halt"`` once the window's wedge budget is spent."""
        self._tick += 1
        self.wedges += 1
        w = self.cfg.window_steps
        self._wedge_ticks = [t for t in self._wedge_ticks if self._tick - t <= w]
        self._wedge_ticks.append(self._tick)
        if len(self._wedge_ticks) >= self.cfg.max_wedges:
            return "halt"
        return "rollback" if self.cfg.rollback else "halt"

    def quarantine(self, fingerprints: list[str]) -> list[str]:
        """Add fingerprints (persisted with ``state_dir``); returns the new ones."""
        new = [f for f in fingerprints if f and f not in self.quarantined]
        if not new:
            return []
        self.quarantined.extend(new)
        if self.cfg.state_dir:
            save_quarantine(self.cfg.state_dir, self.quarantined)
        tel = get_telemetry()
        if tel.enabled:
            tel.counter("sentinel_quarantined_batches_total",
                        "batch fingerprints quarantined by the sentinel").inc(len(new))
        log_dist(f"sentinel: quarantined {len(new)} batch fingerprint(s) ({', '.join(new)})",
                 ranks=[0])
        return new


# ----------------------------------------------------------------- liveness
def heartbeat_path(state_dir: str, rank) -> str:
    """Beacon file of a worker rank (an int) or of a per-stage beacon (a
    string such as ``"0_s1"``)."""
    rank = rank if isinstance(rank, str) else int(rank)
    return os.path.join(state_dir, f"heartbeat_{rank}.json")


class Heartbeat:
    """Per-worker liveness beacon, written from the training thread at step
    boundaries (``Engine._after_step``), never from a helper thread: a
    wedged step stops the beat, and the agent's staleness poll sees a
    worker that is alive but makes no progress."""

    def __init__(self, state_dir: str, rank: int = 0, interval_s: float = 1.0):
        os.makedirs(state_dir, exist_ok=True)
        self.path = heartbeat_path(state_dir, rank)
        self._interval = float(interval_s)
        self._last = 0.0

    def beat(self, step: int) -> bool:
        """Touch the beacon (at most once an ``interval_s``); True when it
        wrote. The mtime is the liveness signal, the payload context."""
        now = time.monotonic()
        if now - self._last < self._interval:
            return False
        self._last = now
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"step": int(step), "pid": os.getpid(), "ts": time.time()}, f)
            os.replace(tmp, self.path)
        except OSError:
            return False
        return True


def watched_call(fn, timeout_s: float):
    """Run ``fn`` on a daemon thread and raise :class:`TrainingWedgeError`
    if it has not returned within ``timeout_s`` (the stuck thread is left
    behind). Exceptions of ``fn`` propagate unchanged."""
    done: dict = {}

    def run():
        try:
            done["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            done["error"] = e

    t = threading.Thread(target=run, name="sentinel-fence", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TrainingWedgeError(f"training dispatch fence exceeded {timeout_s:.1f}s "
                                 "(wedged device program or stuck transfer)")
    if "error" in done:
        raise done["error"]
    return done.get("value")
