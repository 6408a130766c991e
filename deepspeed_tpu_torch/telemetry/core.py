"""The telemetry bus (counterpart of ``deepspeed_tpu/telemetry/core.py``):
one process-local singleton joining the metrics registry, the span/event
log, the request tracer, the SLO monitor and the exporters.

Disabled (the default) it is a no-op behind a single ``if not self.enabled``
flag check on every emit path — no clocks read, no dicts written — so the
serving hot path pays nothing until a run opts in. Every emit reads host
state only: telemetry adds no device synchronisation.

Event records share one shape across sinks::

    {"type": "span"|"event"|"gauge"|"snapshot", "name": ..., "ts": <unix s>,
     "step": <optional>, "dur_s": <spans>, ...free-form attrs...}

The reference's memory ledger, cost meter, fleet reporter, compile watch,
step-anatomy scope and device-memory (HBM) sampling are ROADMAP.md queue 1
item 14: ``configure`` raises ``NotImplementedError`` for any of them
instead of ignoring it, and their accessors (``memledger``, ``costmeter``,
``fleet``, ``compile_watch``) return None, as the reference's do with the
features unconfigured. Unlike the reference, the compile watch and HBM
sampling are off unless asked for.
"""

from __future__ import annotations

import json
import os
import threading
import time

from deepspeed_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deepspeed_tpu_torch.telemetry.tracing import Tracer

# configure() options of features not ported yet (ROADMAP.md queue 1 item 14)
_UNPORTED = {
    "memledger": "the memory ledger (memledger)",
    "costmeter": "cost attribution (costmeter)",
    "fleet": "fleet observability (fleet)",
    "compile_metrics": "the compile watch (compile_watch)",
    "compile_watch": "the compile watch (compile_watch)",
    "stepscope": "the step-anatomy scope (stepscope)",
    "hbm_watermarks": "device-memory sampling (devprof / HBM watermarks)",
    "devprof": "device-memory sampling (devprof / HBM watermarks)",
    "monitor_sink": "the monitor bridge (MonitorSink, monitor/)",
}


def _as_cfg_dict(cfg) -> dict:
    if cfg is None:
        return {}
    if isinstance(cfg, dict):
        return dict(cfg)
    if hasattr(cfg, "to_dict"):
        return dict(cfg.to_dict())
    # plain dataclass / namespace
    return {k: v for k, v in vars(cfg).items() if not k.startswith("_")}


def _wanted(value) -> bool:
    """Whether a configure() option asks for its feature: True, or a dict
    with ``enabled`` true."""
    if isinstance(value, dict):
        return bool(value.get("enabled"))
    return bool(value)


class Telemetry:
    """Process-local telemetry bus (module singleton: ``TELEMETRY``)."""

    def __init__(self):
        self.enabled = False
        self.registry = MetricsRegistry()
        # the tracer object is permanent (engines cache a reference at
        # construction); only its ``enabled`` flag toggles with configure()
        self.tracer = Tracer(self.registry)
        self._slo = None
        self._sinks: list = []
        self._prometheus = None
        self._flush_interval = 100
        self._since_flush = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- configure
    def configure(self, cfg=None, monitor=None, **overrides) -> "Telemetry":
        """(Re)build sinks from a dict / config object / kwargs: ``enabled``,
        ``jsonl_path``, ``prometheus={"enabled", "host", "port"}``,
        ``tracing`` (True or ``{"enabled", "sample_rate",
        "ring_capacity"}``), ``slo`` (True or the reference's threshold
        keys), ``flush_interval_events``.

        Idempotent: reconfiguring tears down the previous sinks and HTTP
        server first, so engines in one process share one bus. Raises
        ``NotImplementedError`` for the options of unported features.
        """
        opts = _as_cfg_dict(cfg)
        opts.update(overrides)
        for key, what in _UNPORTED.items():
            if _wanted(opts.get(key)):
                raise NotImplementedError(
                    f"telemetry option {key!r}: {what} is not ported yet: "
                    "ROADMAP.md queue 1 item 14 (telemetry and the control plane)")
        with self._lock:
            self._teardown_locked()
            self.enabled = bool(opts.get("enabled", True))
            if not self.enabled:
                return self
            self._flush_interval = max(1, int(opts.get("flush_interval_events", 100)))
            jsonl_path = opts.get("jsonl_path")
            if jsonl_path:
                from deepspeed_tpu_torch.telemetry.exporters import JsonlSink

                self._sinks.append(JsonlSink(str(jsonl_path)))
            prom = opts.get("prometheus") or {}
            if prom.get("enabled"):
                from deepspeed_tpu_torch.telemetry.exporters import PrometheusExporter

                self._prometheus = PrometheusExporter(
                    self.registry,
                    host=str(prom.get("host", "127.0.0.1")),
                    port=int(prom.get("port", 9464)),
                )
            tracing = opts.get("tracing") or {}
            if tracing is True:
                tracing = {"enabled": True}
            if tracing.get("enabled"):
                self.tracer.configure(
                    enabled=True,
                    sample_rate=float(tracing.get("sample_rate", 1.0)),
                    ring_capacity=int(tracing.get("ring_capacity", 4096)),
                )
            slo = opts.get("slo") or {}
            if slo is True:
                slo = {"enabled": True}
            if slo.get("enabled"):
                self._slo = self._build_slo(slo)
                self._slo.refresh_gauges()
        self.event("telemetry/configured",
                   sinks=[type(s).__name__ for s in self._sinks],
                   prometheus_port=(self._prometheus.port
                                    if self._prometheus else None),
                   tracing=self.tracer.enabled,
                   slo=self._slo is not None,
                   costmeter=False, memledger=False)
        return self

    def _build_slo(self, slo: dict):
        from deepspeed_tpu_torch.telemetry.slo import (
            SloMonitor,
            default_class_objectives,
            default_objectives,
        )

        # per-SLA-class objectives: explicit per-class threshold dicts, or
        # bare True for the defaults
        classes = slo.get("classes")
        class_objs = None
        if classes is True:
            class_objs = default_class_objectives(
                window_s=float(slo.get("window_s", 300.0)),
                target=float(slo.get("target", 0.99)))
        elif classes:
            class_objs = {
                cls: default_objectives(
                    ttft_threshold_s=float(c.get("ttft_threshold_s", 0.5)),
                    decode_threshold_s=float(c.get("decode_threshold_s", 0.05)),
                    target=float(c.get("target", slo.get("target", 0.99))),
                    window_s=float(c.get("window_s", slo.get("window_s", 300.0))),
                ) for cls, c in classes.items()}
        return SloMonitor(
            default_objectives(
                ttft_threshold_s=float(slo.get("ttft_threshold_s", 0.5)),
                decode_threshold_s=float(slo.get("decode_threshold_s", 0.05)),
                target=float(slo.get("target", 0.99)),
                window_s=float(slo.get("window_s", 300.0)),
            ),
            self.registry,
            burn_threshold=float(slo.get("burn_threshold", 1.0)),
            replica=slo.get("replica"),
            class_objectives=class_objs,
        )

    @property
    def prometheus_port(self) -> int | None:
        return self._prometheus.port if self._prometheus else None

    # ------------------------------------------------------------- metrics
    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self.registry.histogram(name, help, **kw)

    # ------------------------------------------------------------- events
    def emit(self, record: dict) -> None:
        """Append one record to every sink (stamps ``ts`` if absent)."""
        if not self.enabled:
            return
        record.setdefault("ts", time.time())
        for sink in self._sinks:
            try:
                sink.emit(record)
            except Exception:
                pass  # a broken sink must never take down the step loop
        self._since_flush += 1
        if self._since_flush >= self._flush_interval:
            self.flush()

    def event(self, name: str, step: int | None = None, **attrs) -> None:
        if not self.enabled:
            return
        record = {"type": "event", "name": name}
        if step is not None:
            record["step"] = int(step)
        record.update({k: v for k, v in attrs.items() if v is not None})
        self.emit(record)

    def emit_span(self, name: str, dur_s: float, step: int | None = None,
                  **attrs) -> None:
        """Record a pre-measured span: JSONL record + latency histogram."""
        if not self.enabled:
            return
        record = {"type": "span", "name": name, "dur_s": float(dur_s)}
        if step is not None:
            record["step"] = int(step)
        record.update({k: v for k, v in attrs.items() if v is not None})
        self.emit(record)
        self.registry.histogram(
            "span_seconds", "span durations by name").observe(dur_s, name=name)

    # ------------------------------------------------------------- tracing
    def export_chrome_trace(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON of the span ring (Perfetto-loadable)."""
        return self.tracer.export_chrome(trace_id)

    def dump_trace(self, path: str | None = None,
                   trace_id: str | None = None) -> dict:
        """Export the span ring as Chrome trace JSON; writes ``path`` when
        given, returns the trace dict either way."""
        if path is None:
            return self.tracer.export_chrome(trace_id)
        return self.tracer.dump(path, trace_id)

    # ------------------------------------------------------------- slo
    @property
    def slo(self):
        """The configured :class:`SloMonitor`, or None."""
        return self._slo

    def observe_slo(self, objective: str, value_s: float,
                    sla_class: str | None = None) -> None:
        """Record a request latency against an SLO objective (no-op when
        no monitor is configured). ``sla_class`` additionally scores the
        sample against that class's own objectives when configured."""
        slo = self._slo
        if slo is not None:
            slo.record(objective, value_s, sla_class=sla_class)

    # ------------------------------------- unported features (item 14)
    @property
    def memledger(self):
        """The memory ledger: not ported, always None."""
        return None

    @property
    def costmeter(self):
        """The cost meter: not ported, always None."""
        return None

    @property
    def fleet(self):
        """The fleet reporter: not ported, always None."""
        return None

    @property
    def compile_watch(self):
        """The compile watch: not ported, always None."""
        return None

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The full registry as plain data (JSON-serializable)."""
        return {"ts": time.time(), "metrics": self.registry.snapshot()}

    def dump(self, path: str) -> dict:
        """Persist ``snapshot()`` as a JSON file; returns the snapshot."""
        snap = self.snapshot()
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, default=str)
        return snap

    # ------------------------------------------------------------- lifecycle
    def flush(self) -> None:
        self._since_flush = 0
        for sink in self._sinks:
            try:
                sink.flush()
            except Exception:
                pass

    def close(self) -> None:
        """Emit a final registry snapshot record, then tear down all sinks."""
        if self.enabled and self._sinks:
            self.emit({"type": "snapshot", **self.snapshot()})
        with self._lock:
            self._teardown_locked()
        self.enabled = False

    def reset(self) -> None:
        """Back to the pristine disabled state (test isolation)."""
        with self._lock:
            self._teardown_locked()
        self.enabled = False
        self.registry.reset()

    def _teardown_locked(self) -> None:
        for sink in self._sinks:
            try:
                sink.close()
            except Exception:
                pass
        self._sinks = []
        if self._prometheus is not None:
            try:
                self._prometheus.close()
            except Exception:
                pass
            self._prometheus = None
        self._since_flush = 0
        self.tracer.reset()
        self._slo = None


TELEMETRY = Telemetry()
