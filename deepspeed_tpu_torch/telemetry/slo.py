"""SLO burn-rate monitoring over rolling request-latency windows
(counterpart of ``deepspeed_tpu/telemetry/slo.py``).

An objective is "fraction of requests whose latency is under a threshold
must be at least ``target``" — e.g. 99% of requests see TTFT < 200 ms over
the last 5 minutes. The *error budget* is ``1 - target``; the *burn rate*
is the observed bad fraction divided by that budget. Burn rate 1.0 means
the budget is being consumed exactly as fast as it accrues; sustained
burn above ``burn_threshold`` flips the objective to "breaching", which
the serving frontend reflects in ``/healthz`` (status "degraded" — the
replica still serves, but the balancer/operator is told tail latency is
out of budget before users file tickets).

Objectives ship with defaults for the two latencies the ragged engine
already measures per request (``_emit_request_span``): TTFT and mean
per-token decode latency. Samples live in per-objective deques pruned to
the window on every record/read, so memory is bounded by arrival rate x
window and an idle replica decays back to healthy as bad samples age out.

Gauges per objective (labelled ``objective=<name>``):

- ``slo_burn_rate``       bad_fraction / error_budget over the window
- ``slo_good_fraction``   fraction of in-window requests under threshold
- ``slo_window_requests`` sample count backing the estimate
- ``slo_breaching``       1 if burn rate > burn_threshold (min samples met)
"""

from __future__ import annotations

import threading
import time
from collections import deque

# below this many in-window samples a breach verdict is noise, not signal
MIN_SAMPLES = 5


class SloObjective:
    """One rolling-window latency objective."""

    __slots__ = ("name", "threshold_s", "target", "window_s")

    def __init__(self, name: str, threshold_s: float, target: float = 0.99,
                 window_s: float = 300.0):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if threshold_s < 0.0:
            raise ValueError(f"threshold_s must be >= 0, got {threshold_s}")
        self.name = name
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.window_s = float(window_s)


def default_objectives(ttft_threshold_s: float = 0.5,
                       decode_threshold_s: float = 0.05,
                       target: float = 0.99,
                       window_s: float = 300.0) -> list[SloObjective]:
    """The two objectives the ragged engine reports natively: time to
    first token, and mean per-token decode latency."""
    return [
        SloObjective("ttft", ttft_threshold_s, target, window_s),
        SloObjective("decode_latency", decode_threshold_s, target, window_s),
    ]


def default_class_objectives(window_s: float = 300.0,
                             target: float = 0.99) -> dict:
    """Per-SLA-class objective sets (a request's ``sla_class``):
    interactive requests are held to the tight thresholds, batch to relaxed
    ones — each class burns its own error budget so a batch backlog cannot
    mask an interactive-tail regression (or vice versa)."""
    return {
        "interactive": default_objectives(
            ttft_threshold_s=0.5, decode_threshold_s=0.05,
            target=target, window_s=window_s),
        "batch": default_objectives(
            ttft_threshold_s=5.0, decode_threshold_s=0.25,
            target=target, window_s=window_s),
    }


class SloMonitor:
    """Records (timestamp, good?) samples per objective and publishes
    burn-rate gauges into the metrics registry at record and scrape time."""

    MIN_SAMPLES = MIN_SAMPLES

    def __init__(self, objectives, registry, burn_threshold: float = 1.0,
                 replica: str | None = None, class_objectives=None):
        self._objectives = {o.name: o for o in objectives}
        self._samples = {o.name: deque() for o in objectives}
        # per-SLA-class objective sets: {sla_class: [SloObjective, ...]}.
        # Class samples live in their own windows keyed (class, name) and
        # publish {objective=,sla_class=} series; the base (classless)
        # series keeps seeing every record so existing dashboards hold.
        self._class_objectives = {
            cls: {o.name: o for o in objs}
            for cls, objs in (class_objectives or {}).items()}
        self._class_samples = {
            (cls, name): deque()
            for cls, objs in self._class_objectives.items()
            for name in objs}
        self._registry = registry
        self.burn_threshold = float(burn_threshold)
        # distinct replicas' monitors sharing one process (and therefore
        # one registry) publish disjoint series via the replica= label;
        # unnamed monitors keep the bare {objective=} series
        self.replica = str(replica) if replica else None
        self._lock = threading.Lock()

    @property
    def objectives(self):
        return dict(self._objectives)

    # ------------------------------------------------------------- recording
    def record(self, name: str, value_s: float, now: float | None = None,
               sla_class: str | None = None):
        """Record one request latency against objective ``name`` (unknown
        names are ignored so callers need no registration handshake).
        ``sla_class`` additionally scores the sample against that class's
        own threshold/window when class objectives are configured."""
        t = time.monotonic() if now is None else now
        obj = self._objectives.get(name)
        if obj is not None:
            with self._lock:
                window = self._samples[name]
                window.append((t, value_s <= obj.threshold_s))
                self._prune_locked(name, t)
            self._publish(name, t)
        if sla_class is not None:
            cobj = self._class_objectives.get(sla_class, {}).get(name)
            if cobj is not None:
                with self._lock:
                    window = self._class_samples[(sla_class, name)]
                    window.append((t, value_s <= cobj.threshold_s))
                    self._prune_locked(name, t, sla_class)
                self._publish(name, t, sla_class)

    def _prune_locked(self, name: str, now: float,
                      sla_class: str | None = None) -> None:
        if sla_class is None:
            window = self._samples[name]
            horizon = now - self._objectives[name].window_s
        else:
            window = self._class_samples[(sla_class, name)]
            horizon = now - self._class_objectives[sla_class][name].window_s
        while window and window[0][0] < horizon:
            window.popleft()

    # --------------------------------------------------------------- queries
    def stats(self, name: str, now: float | None = None,
              sla_class: str | None = None) -> dict:
        """``{count, good_fraction, burn_rate, breaching}`` for one
        objective over its current window."""
        if sla_class is None:
            obj = self._objectives[name]
        else:
            obj = self._class_objectives[sla_class][name]
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(name, t, sla_class)
            if sla_class is None:
                window = list(self._samples[name])
            else:
                window = list(self._class_samples[(sla_class, name)])
        count = len(window)
        good = sum(1 for _, ok in window if ok)
        good_fraction = good / count if count else 1.0
        budget = 1.0 - obj.target
        burn = (1.0 - good_fraction) / budget if budget > 0 else 0.0
        breaching = count >= self.MIN_SAMPLES and burn > self.burn_threshold
        return {
            "count": count,
            "good_fraction": good_fraction,
            "burn_rate": burn,
            "breaching": breaching,
            "threshold_s": obj.threshold_s,
            "target": obj.target,
            "window_s": obj.window_s,
        }

    def breaching(self) -> bool:
        if any(self.stats(n)["breaching"] for n in self._objectives):
            return True
        return any(self.stats(n, sla_class=cls)["breaching"]
                   for cls, objs in self._class_objectives.items()
                   for n in objs)

    def breaching_classes(self) -> list[tuple[str, str]]:
        """``(sla_class, objective)`` pairs currently out of budget."""
        return [(cls, n)
                for cls, objs in self._class_objectives.items()
                for n in objs
                if self.stats(n, sla_class=cls)["breaching"]]

    def health(self) -> dict:
        """Per-objective summary embedded in the ``/healthz`` body."""
        out = {n: self.stats(n) for n in self._objectives}
        if self._class_objectives:
            out["by_class"] = {
                cls: {n: self.stats(n, sla_class=cls) for n in objs}
                for cls, objs in self._class_objectives.items()}
        return out

    # --------------------------------------------------------------- gauges
    def _publish(self, name: str, now: float | None = None,
                 sla_class: str | None = None) -> None:
        # the clock must follow the caller's (record passes its timestamp
        # through; a wall-clock prune here would evict replayed samples)
        s = self.stats(name, now, sla_class)
        reg = self._registry
        labels = {"objective": name}
        if sla_class is not None:
            labels["sla_class"] = sla_class
        if self.replica is not None:
            labels["replica"] = self.replica
        reg.gauge("slo_burn_rate",
                  "error-budget burn rate over the rolling window"
                  ).set(s["burn_rate"], **labels)
        reg.gauge("slo_good_fraction",
                  "fraction of in-window requests meeting the objective"
                  ).set(s["good_fraction"], **labels)
        reg.gauge("slo_window_requests",
                  "requests backing the rolling SLO estimate"
                  ).set(s["count"], **labels)
        reg.gauge("slo_breaching",
                  "1 when burn rate exceeds the breach threshold"
                  ).set(1.0 if s["breaching"] else 0.0, **labels)

    def refresh_gauges(self) -> None:
        """Re-publish all gauges (call at scrape time so idle windows decay
        visibly without waiting for the next request)."""
        for name in self._objectives:
            self._publish(name)
        for cls, objs in self._class_objectives.items():
            for name in objs:
                self._publish(name, sla_class=cls)
