"""Process-local metrics registry: counters, gauges, histograms with labels
(counterpart of ``deepspeed_tpu/telemetry/registry.py``; the same names,
values and Prometheus text for the same operations).

The registry is the shared data model under every exporter (JSONL and
Prometheus, :mod:`deepspeed_tpu_torch.telemetry.exporters`): emit points
mutate typed metrics here; exporters only ever *read*. Metric updates are
lock-protected so the Prometheus HTTP thread can render a consistent snapshot
while the training loop mutates concurrently.

Naming follows Prometheus conventions (``snake_case``, ``_total`` counters,
``_seconds``/``_bytes`` units); labels keep cardinality bounded (op names,
span names — never uids or step numbers).
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left

# latency-oriented default buckets (seconds): sub-ms dispatches up to
# multi-minute checkpoint flushes
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# pow2 byte-scale buckets for ``*_bytes`` histograms (1 KiB .. 64 GiB):
# staging uploads, KV transfers, checkpoint fragments, OOM-adjacent
# allocation sizes — the seconds-scale defaults would collapse every
# observation into +Inf
BYTE_BUCKETS = tuple(float(2 ** p) for p in range(10, 37, 2))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_metric_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = [f'{_LABEL_RE.sub("_", k)}="{_escape_label_value(v)}"'
             for k, v in (*key, *extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = sanitize_metric_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]

    def render(self) -> list[str]:
        with self._lock:
            return [f"{self.name}{_render_labels(k)} {_fmt(v)}"
                    for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Last-write-wins value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]

    def render(self) -> list[str]:
        with self._lock:
            return [f"{self.name}{_render_labels(k)} {_fmt(v)}"
                    for k, v in sorted(self._series.items())]


class Histogram(_Metric):
    """Fixed-bucket distribution per label set (count/sum + per-bucket counts)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: needs at least one bucket")

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                # [per-bucket counts..., +Inf count], sum, count
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = state
            state[0][bisect_left(self.buckets, value)] += 1
            state[1] += value
            state[2] += 1

    def count(self, **labels) -> int:
        state = self._series.get(_label_key(labels))
        return int(state[2]) if state else 0

    def sum(self, **labels) -> float:
        state = self._series.get(_label_key(labels))
        return float(state[1]) if state else 0.0

    def snapshot(self) -> list[dict]:
        with self._lock:
            out = []
            for k, (counts, total, n) in sorted(self._series.items()):
                cum, buckets = 0, {}
                for le, c in zip(self.buckets, counts):
                    cum += c
                    buckets[repr(float(le))] = cum
                buckets["+Inf"] = n
                out.append({"labels": dict(k), "count": n, "sum": total,
                            "buckets": buckets})
            return out

    def render(self) -> list[str]:
        with self._lock:
            lines = []
            for k, (counts, total, n) in sorted(self._series.items()):
                cum = 0
                for le, c in zip(self.buckets, counts):
                    cum += c
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_render_labels(k, (('le', _fmt(le)),))} {cum}")
                lines.append(
                    f"{self.name}_bucket{_render_labels(k, (('le', '+Inf'),))} {n}")
                lines.append(f"{self.name}_sum{_render_labels(k)} {_fmt(total)}")
                lines.append(f"{self.name}_count{_render_labels(k)} {n}")
            return lines


class MetricsRegistry:
    """Get-or-create metric store; the single source every exporter reads."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        name = sanitize_metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        return {
            m.name: {"kind": m.kind, "help": m.help, "series": m.snapshot()}
            for m in metrics
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
