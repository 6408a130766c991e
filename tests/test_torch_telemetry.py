"""The port's telemetry (``deepspeed_tpu_torch/telemetry``) against the JAX
package's: the registry and its exporters give byte-equal Prometheus text
for the same operations; ``traceparent`` parsing and formatting, and the
Chrome-trace structure apart from times and ids; SLO burn rates on a fixed
series with a fixed clock; ``configure`` refusing the options of unported
features; and the ragged engine's telemetry on one fused-mode run of the
shared serving workload (tests/torch_serving_common.py), which gives the
JAX engine's metric names, deterministic values and span names and counts.
"""

import collections
import http.client
import json

import pytest
import torch_serving_common as common
from torch_serving_common import one_torch_thread  # noqa: F401

from deepspeed_tpu import telemetry as jax_telemetry
from deepspeed_tpu.telemetry import exporters as jax_exporters
from deepspeed_tpu.telemetry import registry as jax_registry
from deepspeed_tpu.telemetry import slo as jax_slo
from deepspeed_tpu.telemetry import tracing as jax_tracing
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.serving import faults
from deepspeed_tpu_torch.telemetry import exporters, registry, slo, tracing


@pytest.fixture(autouse=True)
def fresh_singletons():
    """Both packages' buses and injectors off before and after each test, so
    no other test in the worker sees telemetry on."""
    for reset in (telemetry.TELEMETRY.reset, jax_telemetry.TELEMETRY.reset,
                  faults.get_fault_injector().reset):
        reset()
    yield
    for reset in (telemetry.TELEMETRY.reset, jax_telemetry.TELEMETRY.reset,
                  faults.get_fault_injector().reset):
        reset()


def _drive(reg):
    """The same metric operations on either package's registry."""
    c = reg.counter("requests_total", "requests")
    c.inc()
    c.inc(2.5, route="/v1")
    c.inc(1, route='we"ird\nlabel')
    g = reg.gauge("queue-depth", "queue")
    g.set(7, replica="r0")
    g.inc(3, replica="r0")
    g.dec(1.25, replica="r1")
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.0001, 0.003, 0.2, 7.0, 500.0):
        h.observe(v, op="x")
    hb = reg.histogram("payload_bytes", "bytes", buckets=registry.BYTE_BUCKETS)
    hb.observe(5000)
    hb.observe(2 ** 33)
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("requests_total")
    return reg


def test_registry_prometheus_and_snapshot_match():
    mine = _drive(registry.MetricsRegistry())
    ref = _drive(jax_registry.MetricsRegistry())
    assert mine.render_prometheus() == ref.render_prometheus()
    assert mine.snapshot() == ref.snapshot()
    assert registry.BYTE_BUCKETS == jax_registry.BYTE_BUCKETS


def test_exporters_match(tmp_path):
    mine = _drive(registry.MetricsRegistry())
    records = [{"type": "event", "name": "a", "ts": 1.0, "n": 3},
               {"type": "span", "name": "b", "ts": 2.0, "dur_s": 0.5, "tags": ["x"]}]
    for mod, name in ((exporters, "mine.jsonl"), (jax_exporters, "ref.jsonl")):
        sink = mod.JsonlSink(str(tmp_path / name))
        for r in records:
            sink.emit(r)
        sink.close()
    assert (tmp_path / "mine.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    prom = exporters.PrometheusExporter(mine, port=0)
    try:
        conn = http.client.HTTPConnection(prom.host, prom.port, timeout=30)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == jax_exporters.PrometheusExporter.CONTENT_TYPE
        assert resp.read().decode() == _drive(jax_registry.MetricsRegistry()).render_prometheus()
        conn.close()
    finally:
        prom.close()
    with pytest.raises(NotImplementedError, match="item 14"):
        exporters.MonitorSink(object())


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-03 ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b71692033-01", "garbage", "", None])
def test_traceparent_round_trip(header):
    parsed = tracing.parse_traceparent(header)
    assert parsed == jax_tracing.parse_traceparent(header)
    if parsed is not None:
        trace_id, span_id, sampled = parsed
        ctx = tracing.TraceContext(trace_id, span_id)
        out = tracing.format_traceparent(ctx, sampled)
        assert out == jax_tracing.format_traceparent(
            jax_tracing.TraceContext(trace_id, span_id), sampled)
        assert tracing.parse_traceparent(out) == parsed


def _record(tracer, root_header):
    tracer.configure(enabled=True, sample_rate=1.0, ring_capacity=8)
    root = tracer.extract(root_header)
    child = tracer.record(root, "engine/request", 10.0, 12.0, uid="a", ttft_s=None)
    tracer.record(child, "request/queue", 10.0, 10.5)
    with tracer.span(child, "engine/decode", tokens=4):
        pass
    tracer.finish(root, "http/request", 9.5, 12.5, status=200)
    assert tracer.extract("00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00") is None
    return tracer.export_chrome()


def _structure(trace):
    """The Chrome trace without times, ids, pid and tid: each event's name,
    phase, category and args, and each span's parent by name."""
    names = {e["args"]["span_id"]: e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    out = []
    for e in trace["traceEvents"]:
        args = {k: v for k, v in e["args"].items()
                if k not in ("trace_id", "span_id", "parent_id")}
        out.append((e["name"], e["ph"], e["cat"], json.dumps(args, sort_keys=True),
                    names.get(e["args"].get("parent_id"))))
    return out, trace["displayTimeUnit"], trace["otherData"]["spans"]


def test_chrome_trace_structure_matches():
    header = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    mine = _record(tracing.Tracer(registry.MetricsRegistry()), header)
    ref = _record(jax_tracing.Tracer(jax_registry.MetricsRegistry()), header)
    assert _structure(mine) == _structure(ref)
    assert {e["args"]["trace_id"] for e in mine["traceEvents"] if e["ph"] == "X"} == {
        "0af7651916cd43dd8448eb211c80319c"}
    # head sampling without an upstream header: the deterministic sampler
    kept = []
    for tr in (tracing.Tracer(registry.MetricsRegistry()),
               jax_tracing.Tracer(jax_registry.MetricsRegistry())):
        tr.configure(enabled=True, sample_rate=0.25)
        kept.append([tr.extract(None) is not None for _ in range(12)])
    assert kept[0] == kept[1] and kept[0].count(True) == 3


def _slo_series(mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    mon = mod.SloMonitor(mod.default_objectives(ttft_threshold_s=0.5, window_s=10.0), reg,
                         burn_threshold=1.0, replica="r0",
                         class_objectives=mod.default_class_objectives(window_s=10.0))
    for i, v in enumerate((0.1, 0.9, 0.2, 0.7, 0.05, 0.6, 0.3, 0.8)):
        mon.record("ttft", v, now=100.0 + i, sla_class="interactive" if i % 2 else "batch")
        mon.record("decode_latency", v / 10, now=100.0 + i, sla_class="batch")
    return ({n: mon.stats(n, now=108.0) for n in ("ttft", "decode_latency")},
            mon.stats("ttft", now=115.0),
            mon.stats("ttft", now=108.0, sla_class="interactive"),
            reg.render_prometheus())


def test_slo_burn_rates_match():
    mine, ref = _slo_series(slo, registry), _slo_series(jax_slo, jax_registry)
    assert mine == ref
    assert slo.MIN_SAMPLES == jax_slo.MIN_SAMPLES
    assert mine[0]["ttft"]["breaching"] and mine[0]["ttft"]["count"] == 8


@pytest.mark.parametrize("option", [
    {"memledger": True}, {"costmeter": {"enabled": True}}, {"fleet": True},
    {"compile_metrics": True}, {"stepscope": True}, {"hbm_watermarks": True},
    {"monitor_sink": True}])
def test_configure_refuses_unported(option):
    with pytest.raises(NotImplementedError, match="item 14"):
        telemetry.configure(enabled=True, **option)
    tel = telemetry.get_telemetry()
    assert not tel.enabled
    assert (tel.memledger, tel.costmeter, tel.fleet, tel.compile_watch) == (None,) * 4


def test_engine_telemetry_matches_jax():
    """One fused-mode run of the shared workload with telemetry and tracing
    on in both packages: the same metric names, the same deterministic
    values, the same span names and counts, the same tokens."""
    ref = common.jax_run()
    telemetry.configure(enabled=True, tracing=True)
    eng = common.engine()
    for uid, p in common.requests().items():
        eng.put(uid, p, max_new_tokens=common.MAX_NEW, **common.sampling(uid))
    assert eng.generate_all() == ref["tokens"]
    assert common.engine_counters(eng) == ref["counters"]
    tel = telemetry.get_telemetry()
    snap = tel.registry.snapshot()
    assert sorted(snap) == sorted(ref["metrics"])

    def value(s, name, **labels):
        series = [x for x in s[name]["series"] if x["labels"] == labels]
        return series[0].get("value", series[0].get("count"))

    for name in ("inference_requests_total", "inference_requests_queued_total",
                 "inference_tokens_generated_total", "ragged_h2d_bytes_total",
                 "inference_dispatch_count", "inference_tokens_scheduled",
                 "inference_tokens_padded", "prefix_cache_hits_total",
                 "prefix_cache_misses_total", "prefix_tokens_reused_total",
                 "inference_ttft_seconds", "inference_decode_latency_seconds",
                 "ragged_dispatch_host_ms", "kv_pages_free", "prefix_cache_blocks_published",
                 "prefix_cache_hit_rate", "degraded_mode", "ragged_dispatches_per_token"):
        assert value(snap, name) == value(ref["metrics"], name), name
    assert value(snap, "inference_requests_total") == len(common.requests())
    assert ({tuple(s["labels"].items()) for s in snap["ragged_program_cache_misses_total"]["series"]}
            == {tuple(s["labels"].items())
                for s in ref["metrics"]["ragged_program_cache_misses_total"]["series"]})
    spans = [s["name"] for s in tel.tracer.snapshot()]
    assert collections.Counter(spans) == collections.Counter(ref["spans"])
    # every engine span of a request parents under its engine/request span
    by_id = {s["span_id"]: s for s in tel.tracer.snapshot()}
    for s in tel.tracer.snapshot():
        if s["name"] != "engine/request":
            assert by_id[s["parent_id"]]["name"] == "engine/request"


def test_telemetry_adds_no_device_work():
    """Telemetry reads host counters only: the same run with it on and off
    dispatches, stages and reads back the same, token for token."""
    runs = []
    for on in (False, True):
        telemetry.TELEMETRY.reset()
        if on:
            telemetry.configure(enabled=True, tracing=True, slo=True)
        eng = common.engine()
        reads = []
        read = eng._read
        eng._read = lambda out, pairs: reads.append(1) or read(out, pairs)
        for uid, p in list(common.requests().items())[:6]:
            eng.put(uid, p, max_new_tokens=common.MAX_NEW, **common.sampling(uid))
        runs.append((eng.generate_all(), common.engine_counters(eng), len(reads),
                     eng.forwards))
    assert runs[0] == runs[1]
    assert telemetry.get_telemetry().slo.stats("ttft")["count"] == 6
