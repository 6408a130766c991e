"""Structured telemetry of the port (counterpart of
``deepspeed_tpu/telemetry``): a typed metrics registry with Prometheus text
rendering, a span/event log with a JSONL sink, request tracing with W3C
``traceparent`` propagation and Chrome-trace export, and SLO burn rates.

Typical use::

    from deepspeed_tpu_torch import telemetry

    telemetry.configure(enabled=True, jsonl_path="runs/serve.jsonl",
                        tracing=True)
    telemetry.get_telemetry().counter("my_events_total").inc()

The memory ledger, cost meter, fleet reporter, compile watch, step scope
and device-memory sampling are not ported (ROADMAP.md queue 1 item 14);
``configure`` refuses them.
"""

from deepspeed_tpu_torch.telemetry.core import TELEMETRY, Telemetry  # noqa: F401
from deepspeed_tpu_torch.telemetry.registry import (  # noqa: F401
    BYTE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deepspeed_tpu_torch.telemetry.slo import (  # noqa: F401
    SloMonitor,
    SloObjective,
    default_class_objectives,
    default_objectives,
)
from deepspeed_tpu_torch.telemetry.tracing import (  # noqa: F401
    TraceContext,
    Tracer,
    format_traceparent,
    parse_traceparent,
)


def get_telemetry() -> Telemetry:
    return TELEMETRY


def configure(cfg=None, monitor=None, **overrides) -> Telemetry:
    """Configure the process singleton (see :meth:`Telemetry.configure`)."""
    return TELEMETRY.configure(cfg, monitor=monitor, **overrides)


def snapshot() -> dict:
    return TELEMETRY.snapshot()


def dump(path: str) -> dict:
    return TELEMETRY.dump(path)


def dump_trace(path: str | None = None, trace_id: str | None = None) -> dict:
    """Export the request-trace span ring as Chrome trace-event JSON
    (Perfetto-loadable); writes ``path`` when given."""
    return TELEMETRY.dump_trace(path, trace_id)
