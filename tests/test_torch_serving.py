"""The port's serving tier (``deepspeed_tpu_torch/serving``) against the JAX
package's: protocol validation texts and SSE framing; router placement on
the reference tests' replica tables; and the HTTP stack end to end on the
CPU (``build_server`` over a warmed fused engine): greedy and seeded tokens,
JSON and SSE, equal to the JAX engine's (tests/torch_serving_common.py),
400, 429 with ``Retry-After``, ``/metrics``, ``/healthz``, ``/debug/trace``
under a client ``traceparent``, the debug endpoints of unported features
answering as the reference's do unconfigured, and the SIGTERM drain, which
signals a child process (never the pytest worker).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch_serving_common as common
from torch_serving_common import one_torch_thread  # noqa: F401
from torch_ragged_common import CFG

from deepspeed_tpu import serving as jax_serving
from deepspeed_tpu import telemetry as jax_telemetry
from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch import serving, telemetry
from deepspeed_tpu_torch.serving import (CompletionRequest, EngineLoop, ProtocolError,
                                         ReplicaRouter, RouterConfig, ServingFrontend,
                                         build_server, decode_sse, encode_sse, faults,
                                         plan_placement, sse_done)

TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.fixture(autouse=True)
def fresh_singletons():
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()
    yield
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()


# ---------------------------------------------------------------- protocol
BAD_BODIES = [
    {}, {"prompt": []}, {"prompt": [1, "x"]}, {"prompt": [-1]},
    {"prompt": [1], "max_tokens": 0}, {"prompt": [1], "temperature": -0.1},
    {"prompt": [1], "top_p": 0.0}, {"prompt": [1], "deadline_s": -1},
    {"prompt": [1], "seed": -3}, {"prompt": [1], "frequency_penalty": 1.0},
    {"prompt": [1], "priority": 33}, {"prompt": [1], "priority": 1.5},
    {"prompt": [1], "priority": "high"}, {"prompt": [1], "tenant": ""},
    {"prompt": [1], "tenant": "x" * 65}, {"prompt": [1], "sla_class": "platinum"},
    {"prompt": [1], "top_k": -2}, {"prompt": [1], "max_tokens": "many"}, [1, 2]]


@pytest.mark.parametrize("body", BAD_BODIES, ids=range(len(BAD_BODIES)))
def test_validation_texts_match(body):
    with pytest.raises(ProtocolError) as mine:
        CompletionRequest.from_json(body)
    with pytest.raises(jax_serving.ProtocolError) as ref:
        jax_serving.CompletionRequest.from_json(body)
    assert str(mine.value) == str(ref.value)


def test_sse_and_response_shape_match():
    frames = [{"id": "r1", "token": 17, "index": 0}, "[DONE]", {"a": [1, 2]}]
    for f in frames:
        assert encode_sse(f, event="x") == jax_serving.encode_sse(f, event="x")
    wire = b"".join(encode_sse(f) for f in frames[:1]) + sse_done()
    assert decode_sse(wire) == jax_serving.decode_sse(wire)
    kw = dict(request_id="cmpl-1", tokens=[3, 4], finish_reason="length", prompt_tokens=5,
              created=1.0, trace_id="ab", tenant="t", sla_class="batch")
    assert (serving.CompletionResponse(**kw).to_json()
            == jax_serving.CompletionResponse(**kw).to_json())
    req = CompletionRequest.from_json({"prompt": [3, 1, 4], "max_tokens": 5, "seed": 7})
    assert (req.total_tokens, req.seed, req.sla_class) == (8, 7, "interactive")


# ------------------------------------------------------------------ router
def _tables(mod):
    """The replica tables of the reference's placement tests
    (tests/unit/test_serving.py, tests/unit/test_cluster.py)."""
    def st(name="r0", role="unified", alive=True, draining=False, outstanding_tokens=0,
           free_blocks=48, pending_blocks=0):
        return mod.ReplicaStats(
            name=name, alive=alive, draining=draining, queued=0, inflight=0,
            outstanding_tokens=outstanding_tokens, free_blocks=free_blocks,
            pending_blocks=pending_blocks, block_size=4, usable_blocks=48,
            max_request_blocks=16, max_request_tokens=128, role=role)

    return [
        ([st("a", outstanding_tokens=100), st("b", outstanding_tokens=10),
          st("c", outstanding_tokens=50)], 20, {}, {}),
        ([st(free_blocks=4, pending_blocks=2)], 20, {}, {}),
        ([st("full", outstanding_tokens=5, free_blocks=0),
          st("free", outstanding_tokens=90, free_blocks=48)], 20, {}, {}),
        ([st(outstanding_tokens=60, free_blocks=0)], 20, {"max_queue_tokens": 64}, {}),
        ([st(draining=True), st(alive=False)], 4, {}, {}),
        ([st("pre", role="prefill"), st("dec", role="decode", outstanding_tokens=100)], 20,
         {}, {}),
        ([st("pre", role="prefill")], 20, {}, {}),
        ([st("pre", role="prefill"), st("dec", role="decode")], 20, {},
         {"roles": ("prefill",)}),
        ([st("a", free_blocks=3), st("b", free_blocks=3)], 20, {},
         {"cached_tokens": [0, 12]}),
        ([st("a", outstanding_tokens=40, free_blocks=0), st("b", outstanding_tokens=40)], 30,
         {"max_queue_tokens": 64}, {"tenant_over_share": 0.5}),
    ]


def test_placement_matches_reference():
    mine, ref = _tables(serving), _tables(jax_serving)
    for (stats, total, cfg, kw), (jstats, _, _, _) in zip(mine, ref):
        assert (plan_placement(stats, total, RouterConfig(**cfg), **kw)
                == jax_serving.plan_placement(jstats, total, jax_serving.RouterConfig(**cfg),
                                              **kw))


def test_router_autotune_refused():
    loop = EngineLoop(common.engine(), name="r")
    with pytest.raises(NotImplementedError, match="item 14"):
        ReplicaRouter([loop], RouterConfig(autotune_profile_dir="runs/x"))
    with pytest.raises(NotImplementedError, match="item 14"):
        ServingFrontend(ReplicaRouter([loop]), fleet_dir="runs/fleet")


# -------------------------------------------------------------------- HTTP
def _post(fe, body, headers=None, timeout=120):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=timeout)
    conn.request("POST", "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp, resp.read(), conn


def _get(fe, path):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp, body


def test_http_tokens_match_jax():
    """Every request of the shared workload through HTTP at once, odd ones
    streamed: the JAX engine's tokens; then the endpoints, and a clean
    drain that leaks nothing."""
    # thresholds no CPU run breaches: /healthz then reads the router's state
    telemetry.configure(enabled=True, tracing=True,
                        slo={"enabled": True, "ttft_threshold_s": 60, "decode_threshold_s": 60})
    eng = common.engine()
    eng.warmup()
    eng.warmup(sampled=True, has_tk=True)
    captures = eng.programs.captures
    fe, router, loops = build_server([eng], router_cfg=RouterConfig(max_queue_tokens=4096))
    ref = common.jax_tokens()
    got, errors = {}, []

    def one(i, uid, prompt):
        body = {"prompt": prompt, "max_tokens": common.MAX_NEW, "stream": bool(i % 2),
                **common.sampling(uid)}
        try:
            resp, raw, conn = _post(fe, body, headers={"traceparent": TRACEPARENT} if i == 0
                                    else None)
            conn.close()
            assert resp.status == 200, raw
            if body["stream"]:
                frames = decode_sse(raw)
                assert frames[-1] == "[DONE]"
                toks = [f["token"] for f in frames if "token" in f]
                assert frames[-2]["choices"][0]["tokens"] == toks
            else:
                toks = json.loads(raw)["choices"][0]["tokens"]
                if i == 0:
                    assert resp.getheader("traceparent").split("-")[1] == TRACEPARENT.split("-")[1]
            got[uid] = toks
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i, uid, p))
               for i, (uid, p) in enumerate(common.requests().items())]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert got == ref
        assert eng.programs.captures == captures  # warmed: nothing captured while serving

        resp, raw = _get(fe, "/healthz")
        health = json.loads(raw)
        assert resp.status == 200 and health["status"] == "ready"
        assert health["replicas"][0]["state"] == "healthy" and "slo" in health
        resp, raw = _get(fe, "/metrics")
        page = raw.decode()
        assert resp.status == 200 and resp.getheader("Content-Type").startswith("text/plain")
        assert f"inference_requests_total {len(ref)}" in page
        assert f"serving_requests_admitted_total {len(ref)}" in page
        assert "serving_draining 0" in page and "slo_burn_rate" in page
        trace_id = TRACEPARENT.split("-")[1]
        resp, raw = _get(fe, f"/debug/trace?trace_id={trace_id}")
        names = [e["name"] for e in json.loads(raw)["traceEvents"]]
        assert {"http/request", "router/submit", "loop/inbox_wait", "engine/request",
                "request/admission", "engine/readback"} <= set(names)
        assert names.count("engine/request") == 1
    finally:
        assert fe.drain(timeout=60)
    assert common.leak_free(eng)


def test_errors_and_debug_endpoints_match_reference():
    """400 and 429 (a cold loop: the inbox holds what was submitted, so the
    admission state is exact), and the endpoints of features the port does
    not have, each answering as the reference's frontend does with them
    unconfigured."""
    telemetry.configure(enabled=True)
    jax_telemetry.configure(enabled=True, compile_metrics=False, hbm_watermarks=False)
    cfg = dict(max_queue_tokens=30, retry_after_s=2.5)
    jeng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jax_llama.LlamaConfig(**CFG), ctx=ctx),
        jax_ragged.RaggedConfig(**common.SERVE), dtype=jnp.float32, seed=0)
    fes = [ServingFrontend(ReplicaRouter([EngineLoop(common.engine(), name="cold")],
                                         RouterConfig(**cfg))).start(),
           jax_serving.ServingFrontend(jax_serving.ReplicaRouter(
               [jax_serving.EngineLoop(jeng, name="cold")],
               jax_serving.RouterConfig(**cfg))).start()]
    prompt = common.prompts()[7]
    try:
        answers = []
        for fe in fes:
            mod = serving if isinstance(fe, ServingFrontend) else jax_serving
            fe.router.submit(mod.CompletionRequest(prompt=prompt, max_tokens=10))
            out = []
            for body in ({"prompt": []}, {"prompt": [1], "sla_class": "gold"},
                         {"prompt": prompt, "max_tokens": 10},
                         {"prompt": prompt, "max_tokens": 200}):
                resp, raw, conn = _post(fe, body)
                conn.close()
                out.append((resp.status, resp.getheader("Retry-After"),
                            json.loads(raw)["error"]["message"]))
            for path in ("/healthz", "/debug/memory", "/debug/tenants", "/debug/fleet",
                         "/metrics/fleet", "/nope"):
                resp, raw = _get(fe, path)
                body = json.loads(raw)
                if path == "/healthz":
                    body = (body["status"], [r["state"] for r in body["replicas"]])
                out.append((path, resp.status, body))
            answers.append(out)
        assert answers[0] == answers[1]
        assert answers[0][2][:2] == (429, "2.5")
        resp, raw = _get(fes[0], "/debug/profile")
        assert resp.status == 501 and "item 14" in json.loads(raw)["error"]["message"]
    finally:
        for fe in fes:
            fe.close()


_CHILD = r"""
import json, sys
import torch
from deepspeed_tpu_torch.elasticity.agent import PreemptionHandler
from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.serving import RouterConfig, build_server

cfg, rcfg = json.loads(sys.argv[1]), json.loads(sys.argv[2])
torch.set_num_threads(1)  # as the test files do: the pytest workers share the cores
eng = RaggedInferenceEngine(llama.build(llama.LlamaConfig(**cfg)), RaggedConfig(**rcfg),
                            dtype=torch.float32, seed=0, device="cpu")
fe, router, loops = build_server([eng], router_cfg=RouterConfig(max_queue_tokens=4096))
handler = PreemptionHandler()  # SIGTERM: stop admitting at once (a flag flip)
fe.install_preemption_handler(handler)
print("PORT " + json.dumps(fe.port), flush=True)
while not handler.stop_event.wait(0.02):  # short waits: the handler runs between them
    pass
handler.drain()
handler.restore()
ok = all(lp.join(timeout=120) for lp in loops)
fe.close()
alloc = eng.allocator
leak_free = (not eng.has_work and eng._reserved == 0 and all(r == 0 for r in alloc._refs)
             and len(alloc._free) + alloc.retained_blocks == rcfg["num_blocks"] - 1)
print("DONE " + json.dumps({"joined": ok, "leak_free": leak_free}), flush=True)
"""


def _child_line(child, tag):
    for line in child.stdout:
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise AssertionError(f"the child ended without a {tag} line")


def test_sigterm_drain_in_child_process():
    """SIGTERM to a serving child process, through the port's
    ``PreemptionHandler`` (``install_preemption_handler``): it stops
    admitting at once (503 for new work and /healthz) and finishes the
    requests in flight."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    child = subprocess.Popen([sys.executable, "-c", _CHILD, json.dumps(CFG),
                              json.dumps(common.SERVE)], stdout=subprocess.PIPE, text=True,
                             env=env, cwd=repo)
    try:
        port = _child_line(child, "PORT")
        fe = type("Addr", (), {"host": "127.0.0.1", "port": port})
        results = {}
        started = threading.Barrier(3)

        def run(i):
            conn = http.client.HTTPConnection(fe.host, fe.port, timeout=120)
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"prompt": common.prompts()[i], "max_tokens": 24, "stream": True}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            first = resp.fp.readline()  # the first token's frame: in flight
            started.wait(60)
            results[i] = decode_sse(first + resp.read())
            conn.close()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        started.wait(60)
        child.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            resp, raw = _get(fe, "/healthz")
            if resp.status == 503:
                break
            time.sleep(0.01)
        assert resp.status == 503 and json.loads(raw)["status"] == "draining"
        resp, raw, conn = _post(fe, {"prompt": [1, 2, 3], "max_tokens": 2})
        conn.close()
        assert resp.status == 503
        for t in threads:
            t.join(timeout=120)
        for i in range(2):
            final = results[i][-2]
            assert final["choices"][0]["finish_reason"] == "length"
            assert len(final["choices"][0]["tokens"]) == 24
        assert _child_line(child, "DONE") == {"joined": True, "leak_free": True}
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
