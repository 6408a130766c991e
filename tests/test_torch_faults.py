"""Fault tolerance of the port's serving stack on the CPU: the error
taxonomy mapped onto torch, the injector's deterministic schedules against
the JAX package's, the reference chaos bench's fault schedule through HTTP
(every one of its checks, and tokens equal to the JAX engine's fault-free
run), the degradation ladder's rungs giving the same tokens, crash
containment with failover, and the in-place contracts the captured CUDA
graphs need: ``reset_state()`` and ``_recover_device_path()`` keep every
pool and state tensor where it was (``data_ptr``), and recovery with fused
chunks in flight gives the fault-free tokens.
"""

import http.client
import json
import threading
import time

import pytest
import torch
import torch_serving_common as common
from torch_serving_common import one_torch_thread  # noqa: F401

from deepspeed_tpu.serving import faults as jax_faults
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.ragged import RaggedInferenceEngine
from deepspeed_tpu_torch.serving import RouterConfig, build_server, faults

# bench.py _chaos_bench_impl's schedule, verbatim
CHAOS = [
    {"point": faults.POINT_DISPATCH, "kind": "raise", "after": 1},
    {"point": faults.POINT_READBACK, "kind": "hang", "after": 6, "delay_s": 0.01},
    {"point": faults.POINT_DISPATCH, "kind": "raise", "after": 10, "times": 4},
    {"point": faults.POINT_ALLOC, "kind": "raise", "after": 2},
]
WATCHDOG = dict(dispatch_retries=2, retry_backoff_s=0.01, degrade_after=2)


@pytest.fixture(autouse=True)
def fresh_singletons():
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()
    yield
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()


def _cuda_error():
    accel = getattr(torch, "AcceleratorError", None)
    msg = "CUDA error: an illegal memory access was encountered"
    try:
        return accel(msg) if accel is not None else RuntimeError(msg)
    except TypeError:
        return RuntimeError(msg)


@pytest.mark.parametrize("exc,transient,oom", [
    (faults.FaultError("blip"), True, False),
    (faults.FatalFaultError("bad"), False, False),
    (TimeoutError("wedged readback"), True, False),
    (ConnectionResetError("peer"), True, False),
    (RuntimeError("UNAVAILABLE: try again"), True, False),
    (RuntimeError("shape mismatch"), False, False),
    (faults.FaultError("RESOURCE_EXHAUSTED: injected out-of-memory"), True, True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False,
     True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False, False),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"), False, False),
    (_cuda_error(), False, False),
])
def test_taxonomy(exc, transient, oom):
    assert faults.classify_transient(exc) is transient
    assert faults.is_resource_exhausted(exc) is oom
    if not faults.is_cuda_error(exc) and not isinstance(exc, torch.cuda.OutOfMemoryError):
        # outside CUDA the reference's verdict
        ref_exc = exc
        if isinstance(exc, faults.FaultError):
            ref_exc = (jax_faults.FatalFaultError if not exc.transient
                       else jax_faults.FaultError)(str(exc))
        assert jax_faults.classify_transient(ref_exc) is transient


def _fire_all(mod, seq):
    inj = mod.FaultInjector().configure(
        CHAOS + [{"point": mod.POINT_H2D, "kind": "latency", "delay_s": 0.0, "every": 3,
                  "times": 0},
                 {"point": mod.POINT_SUBMIT, "kind": "raise", "request_id": "r7",
                  "fatal": True},
                 {"point": mod.POINT_LOOP, "kind": "oom", "probability": 0.5, "times": 0}],
        seed=3)
    out = []
    for point, rid in seq:
        try:
            out.append(inj.fire(point, request_id=rid))
        except Exception as e:  # noqa: BLE001 - the outcome is the point
            out.append(type(e).__name__)
    return out, inj.counts(), inj.total_fired()


def test_injector_schedule_matches_reference():
    points = [faults.POINT_DISPATCH, faults.POINT_READBACK, faults.POINT_ALLOC,
              faults.POINT_H2D, faults.POINT_SUBMIT, faults.POINT_LOOP]
    seq = [(points[(i * 7) % len(points)], f"r{i % 9}") for i in range(120)]
    assert _fire_all(faults, seq) == _fire_all(jax_faults, seq)
    assert faults.POINTS == jax_faults.POINTS
    for bad in ({"point": "nowhere"}, {"point": faults.POINT_DISPATCH, "kind": "explode"}):
        with pytest.raises(ValueError):
            faults.FaultSpec(**bad)


def _put_all(eng, uids):
    reqs = common.requests()
    for uid in uids:
        eng.put(uid, reqs[uid], max_new_tokens=common.MAX_NEW, **common.sampling(uid))


def _post(fe, uid):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=120)
    body = {"prompt": common.requests()[uid], "max_tokens": common.MAX_NEW,
            **common.sampling(uid)}
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _get(fe, path):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=30)
    conn.request("GET", path)
    body = conn.getresponse().read()
    conn.close()
    return body


def test_chaos_schedule_checks():
    """bench.py's chaos smoke on the port: 8 seeded requests with staggered
    arrivals under the fixed schedule; its ``checks`` dict, all true."""
    telemetry.configure(enabled=True)
    eng = common.engine(**WATCHDOG)
    eng.warmup(sampled=True, has_tk=True)
    fe, router, loops = build_server([eng], router_cfg=RouterConfig())
    inj = faults.get_fault_injector().configure(CHAOS, seed=0)
    uids = [f"s{i}" for i in range(8)]
    results, lock = {}, threading.Lock()

    def one(uid):
        try:
            got = _post(fe, uid)
        except Exception as e:  # noqa: BLE001 - a dropped connection is a result
            got = (None, {"error": {"reason": str(e)}})
        with lock:
            results[uid] = got

    threads = [threading.Thread(target=one, args=(u,), daemon=True) for u in uids]
    for th in threads:
        th.start()
        time.sleep(0.05)  # stagger arrivals so faults land mid-flight
    for th in threads:
        th.join(timeout=180)
    hung = sum(th.is_alive() for th in threads)
    healthz = json.loads(_get(fe, "/healthz"))
    metrics_text = _get(fe, "/metrics").decode()
    fired = inj.counts()
    inj.reset()
    drained = fe.drain(timeout=60)
    ref = common.jax_tokens()
    completed = [u for u, (st, _) in results.items() if st == 200]
    mismatches = [u for u in completed if results[u][1]["choices"][0]["tokens"] != ref[u]]
    metric_degraded = any(
        line.split()[-1] not in ("0", "0.0") for line in metrics_text.splitlines()
        if line.startswith(("degraded_mode", "replica_degraded_mode")))
    checks = {
        "no_hung_requests": hung == 0,
        "no_leaked_blocks": common.leak_free(eng),
        "drained_clean": bool(drained),
        "all_responses_terminal": len(results) == len(uids),
        "parity_with_fault_free_run": not mismatches and bool(completed),
        "auto_degraded": eng.degraded_mode >= 1,
        "healthz_degraded": healthz.get("status") == "degraded",
        "metrics_degraded": metric_degraded,
    }
    assert all(checks.values()), (checks, fired, results)
    assert len(completed) == len(uids)  # the watchdog absorbed every fault
    assert fired == {faults.POINT_DISPATCH: 5, faults.POINT_READBACK: 1,
                     faults.POINT_ALLOC: 1}
    assert eng.step_retries >= 1 and eng.step_failures >= 5
    assert "fault_injected_total" in metrics_text and "dispatch_retries_total" in metrics_text


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_degradation_rungs_token_identical(rung):
    """Each rung of the ladder, entered by failures, gives the fault-free
    tokens; the program cache keys on the rung's mode."""
    eng = common.engine(degrade_after=1, dispatch_retries=0, retry_backoff_s=0.0)
    for _ in range(rung):
        eng._consec_failures = 1
        assert eng._maybe_degrade(faults.FaultError("x"))
    assert eng.degraded_mode == rung
    assert eng.programs.mode == eng._program_mode()
    assert eng.cfg.device_state is (rung == 0) and bool(eng.cfg.fused_chunk) is (rung < 2)
    _put_all(eng, common.requests())
    assert eng.generate_all() == common.jax_tokens()
    assert common.leak_free(eng)


def _pointers(eng: RaggedInferenceEngine) -> list:
    from deepspeed_tpu_torch.inference.kvquant import kv_leaves

    ts = [x for name in ("k", "v") for x in kv_leaves(eng.cache[name])]
    ts += [*eng._dev_state, eng._bt_dev, eng._slot_toks]
    ts += [e[1] for e in eng._staging.values()]
    if eng._hist_dev is not None:
        ts.append(eng._hist_dev)
    return [t.data_ptr() for t in ts]


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_reset_state_in_place(quant):
    """``reset_state()`` fails what was in flight, keeps every graph-held
    tensor where it is, zeroes the pool and state, tells the prefix
    listener, and the next run gives the cold engine's tokens."""
    eng = common.engine(quant=quant, sched_steps=4, spec_draft=2)

    class Listener:
        resets = 0

        def on_publish(self, key):
            pass

        def on_evict(self, key):
            pass

        def on_reset(self):
            Listener.resets += 1

    eng.set_prefix_listener(Listener())
    uids = [f"g{i}" for i in range(5)]
    _put_all(eng, uids)
    for _ in range(2):
        eng.step()
    live = [s.uid for s in (*eng._queued, *eng._running.values())]
    assert live
    before = _pointers(eng)
    assert eng.reset_state() == len(live)
    assert _pointers(eng) == before
    assert all(eng._results[u].status == "error" for u in live)
    assert Listener.resets == 1 and eng.allocator.listener is not None
    assert common.leak_free(eng) and eng.allocator.retained_blocks == 0
    from deepspeed_tpu_torch.inference.kvquant import kv_leaves

    assert not any(x.view(torch.uint8).any() for n in ("k", "v") for x in kv_leaves(eng.cache[n]))
    assert not eng._dev_state[0].any() and bool((eng._dev_state[-1] == 1).all())
    cold = common.engine(quant=quant, sched_steps=4, spec_draft=2)
    _put_all(eng, common.requests())
    _put_all(cold, common.requests())
    assert eng.generate_all() == cold.generate_all()
    assert set(before) <= set(_pointers(eng))  # new staged lengths add buffers


def test_recovery_with_fused_chunks_in_flight():
    """A dispatch fault while fused chunks are in flight: the watchdog
    rewrites the device rows from the host's tokens in place, and the run
    gives the fault-free tokens."""
    eng = common.engine(degrade_after=0, retry_backoff_s=0.0, dispatch_retries=4)
    inflight = []
    orig = eng._recover_device_path

    def spy():
        inflight.append(len(eng._inflight_chunks))
        pointers = _pointers(eng)
        orig()
        assert _pointers(eng) == pointers
        assert not eng._inflight_chunks and not eng._pending

    eng._recover_device_path = spy
    faults.get_fault_injector().configure([
        {"point": faults.POINT_DISPATCH, "kind": "raise", "after": 6},
        {"point": faults.POINT_READBACK, "kind": "hang", "after": 9, "delay_s": 0.0},
        {"point": faults.POINT_DISPATCH, "kind": "raise", "after": 14, "times": 2}])
    _put_all(eng, common.requests())
    assert eng.generate_all() == common.jax_tokens()
    assert eng.step_failures == 4 and eng.degraded_mode == 0
    assert inflight and max(inflight) >= 2
    assert common.leak_free(eng)


def test_crash_containment_then_failover():
    """A fatal fault: the loop contains it (the engine's state reset), the
    frontend fails the request over, and the client gets the fault-free
    tokens."""
    telemetry.configure(enabled=True)
    eng = common.engine()
    fe, router, loops = build_server([eng], router_cfg=RouterConfig())
    faults.get_fault_injector().configure(
        [{"point": faults.POINT_DISPATCH, "kind": "raise", "after": 2, "fatal": True}])
    try:
        status, body = _post(fe, "s3")
        assert status == 200 and body["choices"][0]["tokens"] == common.jax_tokens()["s3"]
        assert loops[0].crash_count == 1 and eng.step_failures == 0
        assert "engine_loop_crashes_total" in _get(fe, "/metrics").decode()
    finally:
        assert fe.drain(timeout=60)
    assert common.leak_free(eng)
