"""Request tracing: W3C trace context, a bounded span ring, Chrome export
(counterpart of ``deepspeed_tpu/telemetry/tracing.py``).

A trace is a tree of spans sharing one 128-bit trace id; the serving
frontend accepts or creates a ``traceparent`` header (W3C Trace Context),
the context threads through router -> engine loop -> ragged engine, and every
stage records its spans retroactively from ``time.perf_counter()`` stamps it
already takes.

Design constraints, in order:

- **Off is free.** The default is off; every emit point guards on a single
  ``tracer.enabled`` attribute read (or a ``seq.trace is not None`` check on
  state that is only ever set while tracing), so the ragged dispatch hot
  path performs zero additional allocations per step.
- **Bounded.** Finished spans land in a ring (``collections.deque`` with
  ``maxlen``); a forgotten tracer can never OOM a serving replica. Sampling
  is head-based: the keep/drop decision is made once when the trace starts
  (or inherited from the upstream ``traceparent`` sampled flag) and the
  whole tree follows it — no partial trees.
- **Retro-recorded.** Spans are appended *finished* (t0, t1 pairs), so no
  open-span registry is held across threads and a crashed request leaks
  nothing.

Export is Chrome trace-event JSON (``ph: "X"`` complete events, microsecond
timestamps) loadable directly in Perfetto / ``chrome://tracing``, via
``Telemetry.dump_trace()`` or the serving frontend's ``GET /debug/trace``.
Every finished span also feeds the ``trace_span_seconds{name=}`` histogram
in the metrics registry, so span latencies are queryable from Prometheus
without pulling trace JSON.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# spec: all-zero ids are invalid; version ff is reserved
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16


class TraceContext:
    """One node of a trace tree: (trace_id, span_id, parent_id).

    Handed to a stage *before* its span is recorded so children created
    meanwhile can parent to it — record order is irrelevant to the export.
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id[:8]}…, span={self.span_id}, "
                f"parent={self.parent_id})")


def parse_traceparent(header) -> tuple[str, str, bool] | None:
    """``(trace_id, parent_span_id, sampled)`` from a W3C ``traceparent``
    header, or None if the header is absent/malformed (per spec a broken
    header is ignored and a fresh trace may be started)."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == _ZERO_TRACE or span_id == _ZERO_SPAN:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


def format_traceparent(ctx: TraceContext, sampled: bool = True) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if sampled else '00'}"


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Process-local span recorder (owned by the ``Telemetry`` singleton).

    All methods are safe to call with the tracer disabled — they return
    None/no-op — but hot paths should guard on ``tracer.enabled`` (one
    attribute read) and skip even the call.
    """

    def __init__(self, registry):
        self.enabled = False
        self.registry = registry
        self.sample_rate = 1.0
        self._ring: deque = deque(maxlen=4096)
        self._lock = threading.Lock()
        self._sample_n = 0
        # perf_counter <-> wall-clock anchor for export timestamps
        self._epoch_pc = time.perf_counter()
        self._epoch_unix = time.time()

    # ------------------------------------------------------------ configure
    def configure(self, enabled: bool = True, sample_rate: float = 1.0,
                  ring_capacity: int = 4096) -> "Tracer":
        with self._lock:
            self.enabled = bool(enabled)
            self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
            cap = max(1, int(ring_capacity))
            if cap != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=cap)
            self._sample_n = 0
            self._epoch_pc = time.perf_counter()
            self._epoch_unix = time.time()
        return self

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self.sample_rate = 1.0
            self._ring.clear()
            self._sample_n = 0

    # -------------------------------------------------------------- context
    def _head_sampled(self) -> bool:
        """Deterministic head sampler: admits ``ceil(rate * n)`` of the
        first n roots (no RNG, so tests and replays are stable)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        n = self._sample_n
        self._sample_n = n + 1
        return int((n + 1) * self.sample_rate) > int(n * self.sample_rate)

    def extract(self, traceparent: str | None = None) -> TraceContext | None:
        """Context for a new *server-side root span* from an incoming
        ``traceparent`` header (or None to head-sample a fresh trace).

        Returns None when tracing is off, the upstream explicitly opted out
        (sampled flag 0 — head-based sampling honors the caller's decision),
        or the head sampler drops the trace. A returned context's span id is
        pre-allocated: record children under it first, then ``finish`` it.
        """
        if not self.enabled:
            return None
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_span, sampled = parsed
            if not sampled:
                return None
            return TraceContext(trace_id, _new_span_id(), parent_span)
        if not self._head_sampled():
            return None
        return TraceContext(uuid.uuid4().hex, _new_span_id(), None)

    def begin(self, parent: TraceContext | None) -> TraceContext | None:
        """Allocate a child context under ``parent`` (None passes through,
        so call sites can chain without re-guarding)."""
        if parent is None or not self.enabled:
            return None
        return TraceContext(parent.trace_id, _new_span_id(), parent.span_id)

    # ------------------------------------------------------------ recording
    def finish(self, ctx: TraceContext | None, name: str, t0: float,
               t1: float, **attrs) -> None:
        """Append one finished span for a pre-allocated context. ``t0``/
        ``t1`` are ``time.perf_counter()`` stamps; attrs must be
        JSON-serializable and low-cardinality enough to read."""
        if ctx is None or not self.enabled:
            return
        dur = max(0.0, t1 - t0)
        self._ring.append({
            "name": name, "trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "parent_id": ctx.parent_id, "t0": t0, "dur_s": dur,
            "tid": threading.get_ident(),
            "attrs": {k: v for k, v in attrs.items() if v is not None},
        })
        self.registry.histogram(
            "trace_span_seconds",
            "traced span durations by span name").observe(dur, name=name)

    def record(self, parent: TraceContext | None, name: str, t0: float,
               t1: float, **attrs) -> TraceContext | None:
        """begin + finish in one call; returns the recorded span's context
        so later spans can still parent to it."""
        ctx = self.begin(parent)
        self.finish(ctx, name, t0, t1, **attrs)
        return ctx

    @contextmanager
    def span(self, parent: TraceContext | None, name: str, **attrs):
        """Measure a block as a child span; yields the child context (None
        when not tracing, so nested call sites stay guard-free)."""
        ctx = self.begin(parent)
        if ctx is None:
            yield None
            return
        t0 = time.perf_counter()
        try:
            yield ctx
        finally:
            self.finish(ctx, name, t0, time.perf_counter(), **attrs)

    # -------------------------------------------------------------- export
    def snapshot(self, trace_id: str | None = None) -> list[dict]:
        """Finished spans currently in the ring (oldest first), optionally
        filtered to one trace."""
        spans = list(self._ring)
        if trace_id:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def export_chrome(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): one ``ph: "X"``
        complete event per span, microsecond timestamps relative to the
        tracer epoch, thread ids preserved so per-thread tracks nest by
        timestamp containment."""
        pid = os.getpid()
        events = []
        for s in self.snapshot(trace_id):
            args = dict(s["attrs"])
            args["trace_id"] = s["trace_id"]
            args["span_id"] = s["span_id"]
            if s["parent_id"]:
                args["parent_id"] = s["parent_id"]
            events.append({
                "name": s["name"], "ph": "X", "cat": "request",
                "ts": (s["t0"] - self._epoch_pc) * 1e6,
                "dur": s["dur_s"] * 1e6,
                "pid": pid, "tid": s["tid"], "args": args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix_s": self._epoch_unix,
                "spans": len(events),
            },
        }

    def dump(self, path: str, trace_id: str | None = None) -> dict:
        trace = self.export_chrome(trace_id)
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace
