"""Pluggable telemetry exporters (counterpart of
``deepspeed_tpu/telemetry/exporters.py``).

Two sinks over one data model (:mod:`deepspeed_tpu_torch.telemetry.registry`
and the span/event records :class:`deepspeed_tpu_torch.telemetry.core.Telemetry`
emits):

- :class:`JsonlSink` — append-only JSONL event log (machine-readable run
  record).
- :class:`PrometheusExporter` — text exposition format 0.0.4 on a stdlib
  ``ThreadingHTTPServer`` daemon thread (``GET /metrics``); no third-party
  client library required.

The reference's third sink, ``MonitorSink`` (the bridge into the monitor
writers), waits for the port of ``monitor/`` (ROADMAP.md queue 1 item 14):
building one raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from deepspeed_tpu_torch.utils.logging import log_dist


def _json_default(obj):
    # numpy scalars / arrays and anything else that slips into a record
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


class JsonlSink:
    """One JSON object per line; buffered file handle, explicit flush/close."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


class MonitorSink:
    """The monitor bridge: not ported (``monitor/`` is ROADMAP.md queue 1
    item 14)."""

    def __init__(self, monitor):
        raise NotImplementedError(
            "telemetry MonitorSink is not ported yet: it bridges into monitor/, "
            "ROADMAP.md queue 1 item 14 (telemetry and the control plane)")


class PrometheusExporter:
    """``GET /metrics`` over stdlib http.server; renders the live registry.

    ``port=0`` binds an ephemeral port (tests); the bound port is on ``.port``.
    The server thread is a daemon: it never blocks interpreter exit.
    """

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 9464):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = exporter.registry.render_prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", exporter.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass  # scrapes must not spam the logs

        self.registry = registry
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="telemetry-prometheus",
            daemon=True)
        self._thread.start()
        log_dist(
            f"telemetry: prometheus endpoint on http://{self.host}:{self.port}/metrics",
            ranks=[0])

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
