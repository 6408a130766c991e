"""HTTP frontend over the replica router, stdlib ``http.server`` only
(counterpart of ``deepspeed_tpu/serving/frontend.py``).

Endpoints:

- ``POST /v1/completions`` — OpenAI-completions-shaped JSON body (token-id
  prompts; see ``protocol.py``). Non-streaming returns one JSON
  ``CompletionResponse``; ``"stream": true`` returns ``text/event-stream``
  with one frame per token, a final frame carrying the full response, then
  the ``[DONE]`` terminator. Backpressure surfaces as 429 + ``Retry-After``
  (admission control) and 503 (draining); client disconnect mid-stream
  cancels the request so its KV blocks free on the next engine step.
- ``GET /healthz`` — ``{"status": ready|degraded|overloaded|draining}``;
  200 when servable, 503 while draining (load-balancer semantics: stop
  sending). With an SLO monitor configured the body embeds per-objective
  burn-rate stats, and a sustained burn flips a ready replica to
  ``degraded`` (still 200 — it can serve, but tail latency is out of
  budget).
- ``GET /metrics`` — Prometheus text exposition straight from the
  telemetry registry (serving + SLO gauges refreshed at scrape time).
  Serving a scrape endpoint here does not flip telemetry on: with
  telemetry disabled the page renders whatever the registry holds
  (typically nothing) and the serving hot path still emits zero metrics.
- ``GET /debug/trace`` — the request-trace span ring as Chrome
  trace-event JSON (load in Perfetto); ``?trace_id=<32hex>`` filters to
  one trace.
- ``GET /debug/memory`` / ``GET /debug/tenants`` — ``{"enabled": false}``
  (the memory ledger and the cost meter are ROADMAP.md queue 1 item 14),
  plus the per-replica KV tier rows under ``kv_tiers`` when tiering is on.
- ``GET /metrics/fleet`` — 404 and ``GET /debug/fleet`` —
  ``{"enabled": false}``, as the reference answers with no fleet dir
  configured (fleet observability is item 14: ``fleet_dir`` raises).
- ``GET /debug/profile`` — 501: device profiling is item 14.

Tracing: ``POST /v1/completions`` honors an incoming W3C ``traceparent``
header (or head-samples a fresh trace when the tracer is enabled); the
trace id is echoed in a ``traceparent`` response header, the response
body, and every SSE token frame, and the context threads through router →
engine loop → ragged engine so the exported timeline decomposes the
request into queue/admission/dispatch/readback spans.

``ThreadingHTTPServer`` gives a thread per connection, which is what SSE
needs: a streaming response parks its thread on the request's TokenStream
while the single engine-loop thread keeps stepping.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from deepspeed_tpu_torch.serving.engine_loop import StreamError
from deepspeed_tpu_torch.serving.protocol import (
    CompletionRequest,
    CompletionResponse,
    ProtocolError,
    encode_sse,
    sse_done,
)
from deepspeed_tpu_torch.serving.router import (
    DeadlineExceeded,
    Draining,
    Overloaded,
    ReplicaRouter,
)
from deepspeed_tpu_torch.telemetry import get_telemetry
from deepspeed_tpu_torch.telemetry.exporters import PrometheusExporter
from deepspeed_tpu_torch.telemetry.tracing import format_traceparent
from deepspeed_tpu_torch.utils.logging import log_dist


class ServingFrontend:
    """Bind + serve the HTTP surface for one ReplicaRouter."""

    def __init__(self, router: ReplicaRouter, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0,
                 fleet_dir: str | None = None):
        self.router = router
        self.request_timeout_s = float(request_timeout_s)
        if fleet_dir is not None:
            raise NotImplementedError(
                "ServingFrontend(fleet_dir=...): fleet observability is not ported yet: "
                "ROADMAP.md queue 1 item 14 (telemetry and the control plane)")
        handler = _make_handler(self)
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serving-frontend",
            daemon=True)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServingFrontend":
        self._thread.start()
        log_dist(f"serving frontend listening on {self.host}:{self.port}",
                 ranks=[0])
        return self

    def install_preemption_handler(self, handler) -> None:
        """Register drain on a preemption handler (an object with
        ``register(name, fn, immediate=True)``): SIGTERM -> stop admitting
        immediately (flag flips only, signal-safe); inflight requests
        finish and the engine loops exit on their own threads."""
        handler.register("serving-drain", self.router.begin_drain,
                         immediate=True)

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting, wait for inflight work, stop the HTTP listener."""
        ok = self.router.drain(timeout)
        self.close()
        return ok

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _make_handler(frontend: ServingFrontend):
    router = frontend.router

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # the request's sampled TraceContext (POST path), echoed on replies
        _trace_ctx = None
        _last_code = 0

        def log_message(self, fmt, *args):  # noqa: A003 - http.server API
            pass  # request logging goes through telemetry, not stderr

        # ------------------------------------------------------- helpers
        def _send_json(self, code: int, payload: dict,
                       headers: dict | None = None) -> None:
            body = json.dumps(payload).encode("utf-8")
            self._last_code = code
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._trace_ctx is not None:
                self.send_header("traceparent",
                                 format_traceparent(self._trace_ctx))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_error_json(self, code: int, message: str,
                             headers: dict | None = None, **detail) -> None:
            err = {"message": message, "code": code}
            err.update(detail)
            self._send_json(code, {"error": err}, headers)

        # ----------------------------------------------------------- GET
        def do_GET(self):  # noqa: N802 - http.server API
            # keep-alive reuses the handler across requests: clear any
            # trace context left by an earlier POST on this connection
            self._trace_ctx = None
            # route on the path alone — /metrics?foo=1 is still /metrics
            # (matches the standalone PrometheusExporter's behavior)
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                state = router.state()
                payload = {"status": state, "replicas": router.health()}
                cluster_stats = getattr(router, "cluster_stats", None)
                if cluster_stats is not None:
                    # a ServingCluster fronts the router: expose roles,
                    # prefix-index coverage, handoff/fallback counters
                    payload["cluster"] = cluster_stats()
                slo = get_telemetry().slo
                if slo is not None:
                    payload["slo"] = slo.health()
                    if state == "ready" and slo.breaching():
                        # still 200: the replica can serve, but tail
                        # latency is burning error budget — operators and
                        # balancers can deprioritize without ejecting it
                        payload["status"] = "degraded"
                self._send_json(503 if state == "draining" else 200, payload)
            elif path == "/metrics/fleet":
                self._send_error_json(
                    404, "no fleet dir configured "
                    "(telemetry.configure(fleet={...}))")
            elif path == "/debug/fleet":
                self._send_json(200, {"enabled": False})
            elif path == "/debug/tenants":
                self._send_json(200, {"enabled": False})
            elif path == "/metrics":
                router.refresh_metrics()
                tel = get_telemetry()
                if tel.slo is not None:
                    tel.slo.refresh_gauges()
                body = tel.registry.render_prometheus()
                body = body.encode("utf-8")
                self._last_code = 200
                self.send_response(200)
                self.send_header("Content-Type",
                                 PrometheusExporter.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/debug/trace":
                trace_id = (parse_qs(query).get("trace_id") or [None])[0]
                self._send_json(
                    200, get_telemetry().export_chrome_trace(trace_id))
            elif path == "/debug/memory":
                payload = {"enabled": False}
                tiers = getattr(router, "tier_stats", None)
                if tiers is not None:
                    # per-replica KV tier rows (host/disk bytes, demotion/
                    # promotion/prefetch counters) ride along so operators
                    # see where off-device KV bytes live
                    t = tiers()
                    if t:
                        payload["kv_tiers"] = t
                self._send_json(200, payload)
            elif path == "/debug/profile":
                self._send_error_json(
                    501, "device profiling is not ported yet: ROADMAP.md "
                    "queue 1 item 14 (telemetry and the control plane)")
            else:
                self._send_error_json(404, f"no route for {path}")

        # ---------------------------------------------------------- POST
        def do_POST(self):  # noqa: N802 - http.server API
            path = self.path.partition("?")[0]
            if path != "/v1/completions":
                self._send_error_json(404, f"no route for {path}")
                return
            tracer = get_telemetry().tracer
            # root server span: pre-allocated so everything downstream
            # (router, engine loop, ragged engine) parents under it;
            # recorded retroactively once the response is on the wire
            ctx = tracer.extract(self.headers.get("traceparent"))
            self._trace_ctx = ctx
            self._last_code = 0
            t_req = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._send_error_json(400, "request body is not valid JSON")
                return
            try:
                req = CompletionRequest.from_json(body)
                req.trace_ctx = ctx
                req.t_submit = t_req
                stream = router.submit(req)
            except ProtocolError as e:
                self._send_error_json(400, str(e))
                return
            except Overloaded as e:
                self._send_error_json(
                    429, str(e),
                    headers={"Retry-After": f"{e.retry_after_s:g}"})
                return
            except Draining as e:
                self._send_error_json(503, str(e))
                return
            except DeadlineExceeded as e:
                self._send_error_json(504, str(e),
                                      headers={"Retry-After": "1"})
                return
            finally:
                if ctx is not None and self._last_code:
                    # submit was rejected: close the root span here (the
                    # success path closes it after the response is sent)
                    tracer.finish(ctx, "http/request", t_req,
                                  time.perf_counter(),
                                  status=self._last_code)
            try:
                if req.stream:
                    self._stream_response(req, stream)
                else:
                    self._full_response(req, stream)
            finally:
                router.release(req.request_id)
                if ctx is not None:
                    tracer.finish(ctx, "http/request", t_req,
                                  time.perf_counter(),
                                  status=self._last_code,
                                  request_id=req.request_id,
                                  stream=req.stream)

        # stream error_reasons that mean the replica (not the request) is at
        # fault: the request is replayable token-identically elsewhere
        _FAILOVER_REASONS = ("replica_died", "engine_crash")

        def _full_response(self, req, stream) -> None:
            try:
                while True:
                    try:
                        tokens, reason = stream.collect(
                            timeout=frontend.request_timeout_s)
                        break
                    except StreamError as e:
                        if stream.error_reason in self._FAILOVER_REASONS:
                            replay = router.resubmit(req)
                            if replay is not None:
                                stream = replay
                                continue
                        code = stream.error_code or 400
                        detail = {}
                        if stream.error_reason:
                            detail["reason"] = stream.error_reason
                        self._send_error_json(
                            code, str(e),
                            headers=({"Retry-After": "1"}
                                     if code in (503, 504) else None),
                            **detail)
                        return
            except TimeoutError as e:
                # the engine never finished inside the frontend's budget:
                # that is a gateway timeout, not a client error. Abort the
                # request (frees its KV blocks on the next engine step) and
                # tell the client when a retry is reasonable.
                router.cancel(req.request_id)
                self._send_error_json(
                    504,
                    f"request did not complete within "
                    f"{frontend.request_timeout_s:g}s: {e}",
                    headers={"Retry-After": "1"},
                    retry_after_s=1.0,
                    timeout_s=frontend.request_timeout_s)
                return
            resp = CompletionResponse(
                request_id=req.request_id, tokens=tokens,
                finish_reason=reason, prompt_tokens=len(req.prompt),
                trace_id=(req.trace_ctx.trace_id
                          if req.trace_ctx is not None else None),
                tenant=req.tenant, sla_class=req.sla_class)
            self._send_json(200, resp.to_json())

        def _stream_response(self, req, stream) -> None:
            self._last_code = 200
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            if req.trace_ctx is not None:
                self.send_header("traceparent",
                                 format_traceparent(req.trace_ctx))
            # no Content-Length for a live stream: HTTP/1.1 needs an
            # explicit close to delimit the body
            self.send_header("Connection", "close")
            self.end_headers()
            trace_id = (req.trace_ctx.trace_id
                        if req.trace_ctx is not None else None)
            tokens: list[int] = []
            try:
                while True:
                    resubmitted = False
                    # on failover the replacement stream replays from token
                    # 0 (deterministic per-request seeds); skip the prefix
                    # already on the wire and splice the tail seamlessly
                    skip, seen = len(tokens), 0
                    for kind, value in stream.events(
                            timeout=frontend.request_timeout_s):
                        if kind == "token":
                            seen += 1
                            if seen <= skip:
                                continue
                            frame = {"id": req.request_id, "token": value,
                                     "index": len(tokens)}
                            if trace_id:
                                frame["trace_id"] = trace_id
                            self.wfile.write(encode_sse(frame))
                            self.wfile.flush()
                            tokens.append(value)
                        elif kind == "error":
                            if (stream.error_reason
                                    in self._FAILOVER_REASONS):
                                replay = router.resubmit(req)
                                if replay is not None:
                                    stream = replay
                                    resubmitted = True
                                    break
                            self.wfile.write(encode_sse(
                                {"id": req.request_id, "error": value},
                                event="error"))
                            break
                        else:  # done
                            resp = CompletionResponse(
                                request_id=req.request_id, tokens=tokens,
                                finish_reason=value,
                                prompt_tokens=len(req.prompt),
                                trace_id=trace_id,
                                tenant=req.tenant, sla_class=req.sla_class)
                            self.wfile.write(encode_sse(resp.to_json()))
                            self.wfile.write(sse_done())
                    if not resubmitted:
                        break
                self.wfile.flush()
            except (BrokenPipeError, ConnectionError, TimeoutError, OSError):
                # client went away (or stalled past the deadline): abort the
                # request so its KV blocks free on the next engine step
                router.cancel(req.request_id)
                self.close_connection = True

    return Handler


def build_server(engines, host: str = "127.0.0.1", port: int = 0,
                 router_cfg=None, start: bool = True):
    """Convenience: EngineLoop-wrap ``engines``, route, bind, and start.

    Returns ``(frontend, router, loops)``; pass ``start=False`` to leave
    the loops and listener cold (tests use this for determinism). Call each
    engine's ``warmup()`` first: the loops then capture nothing while they
    serve.
    """
    from deepspeed_tpu_torch.serving.engine_loop import EngineLoop

    loops = [EngineLoop(e, name=f"replica-{i}") for i, e in enumerate(engines)]
    router = ReplicaRouter(loops, router_cfg)
    frontend = ServingFrontend(router, host=host, port=port)
    if start:
        for lp in loops:
            lp.start()
        frontend.start()
    return frontend, router, loops
