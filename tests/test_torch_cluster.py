"""Disaggregated serving on the port (``serving/cluster.py``) on the CPU:
``build_cluster_server([prefill], [decode])`` over two engines sharing
their weights serves the shared workload (tests/torch_serving_common.py,
two shared prefixes, greedy and seeded) through HTTP with every request's
prompt on the prefill engine and its decode on the decode engine after a
KV handoff, giving the JAX engine's tokens; the cluster prefix index hits;
the drain runs begin_drain -> join -> close. The index and the transfer
cost model are held to the JAX package's.
"""

import http.client
import json
import threading

import pytest
import torch_serving_common as common
from torch_serving_common import one_torch_thread  # noqa: F401

from deepspeed_tpu.serving import cluster as jax_cluster
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.serving import (ClusterConfig, build_cluster_server, decode_sse, faults,
                                         transfer_beats_prefill)
from deepspeed_tpu_torch.serving import cluster as cluster_mod


@pytest.fixture(autouse=True)
def fresh_singletons():
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()
    yield
    for reset in (telemetry.TELEMETRY.reset, faults.get_fault_injector().reset):
        reset()


def _drive_index(mod):
    idx = mod.ClusterPrefixIndex()
    prompt = list(range(20))
    keys, key = [], None
    for i in range(4):
        key = (key, tuple(prompt[i * 4:(i + 1) * 4]))
        keys.append(key)
    out = []
    for k in keys[:3]:
        idx.publish("a", k)
    for k in keys:
        idx.publish("b", k)
    out.append(idx.best_holder(prompt, 4))
    idx.demote("b", keys[0])
    out.append(idx.best_holder(prompt[:13], 4))
    idx.evict("b", keys[3])
    out.append(idx.best_holder(prompt, 4, exclude=frozenset({"a"})))
    out.append(idx.drop_replica("a"))
    out.append(idx.best_holder(prompt, 4))
    out.append(idx.best_holder([99] * 9, 4))
    out.append(idx.stats())
    return out


def test_index_and_cost_model_match_reference():
    assert _drive_index(cluster_mod) == _drive_index(jax_cluster)
    for tokens, bpt, gbps, rate in ((64, 4096, 10.0, 50000.0), (64, 10 ** 7, 10.0, 50000.0),
                                    (0, 1, 10.0, 1.0), (8, 1, -1.0, 1.0)):
        cfg = dict(transfer_gbps=gbps, prefill_tokens_per_s=rate)
        assert (transfer_beats_prefill(tokens, bpt, ClusterConfig(**cfg))
                == jax_cluster.transfer_beats_prefill(tokens, bpt,
                                                      jax_cluster.ClusterConfig(**cfg)))


def _post(fe, uid):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=120)
    body = {"prompt": common.requests()[uid], "max_tokens": common.MAX_NEW,
            "stream": uid[-1] in "13579", **common.sampling(uid)}
    conn.request("POST", "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    assert resp.status == 200, raw
    if body["stream"]:
        return [f["token"] for f in decode_sse(raw) if "token" in f]
    return json.loads(raw)["choices"][0]["tokens"]


def test_disaggregated_tokens_match_one_engine():
    telemetry.configure(enabled=True, tracing=True)
    prefill, decode = common.engine(), common.engine()
    assert prefill.params["embed"] is decode.params["embed"]  # shared weights
    for eng in (prefill, decode):
        eng.warmup()
        eng.warmup(sampled=True, has_tk=True)
    fe, cluster, loops = build_cluster_server([prefill], [decode])
    ref = common.jax_tokens()
    got, errors = {}, []
    uids = list(common.requests())

    def one(uid):
        try:
            got[uid] = _post(fe, uid)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(repr(e))

    # one request on each prefix first, so the later ones find it indexed;
    # then waves of max_seqs at once: a decode engine with every slot taken
    # rejects an import, and the cluster falls back to a cold submit
    for uid in uids[:2]:
        one(uid)
    wave = common.SERVE["max_seqs"]
    for i in range(2, len(uids), wave):
        threads = [threading.Thread(target=one, args=(u,)) for u in uids[i:i + wave]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    for _ in range(500):  # a worker counts its handoff after the response ends
        stats = cluster.cluster_stats()
        if stats["handoffs"]["ok"] + stats["handoffs"]["failed"] + sum(
                stats["fallbacks"].values()) >= len(uids):
            break
        threading.Event().wait(0.01)
    cluster.begin_drain()
    joined = [lp.join(timeout=60) for lp in loops]
    fe.close()
    assert not errors, errors
    assert got == ref
    assert all(joined)
    assert stats["disagg_requests"] == len(uids)
    assert stats["handoffs"]["ok"] == len(uids) and stats["handoffs"]["failed"] == 0, stats
    assert stats["prefix_index"]["hits"] > 0 and not stats["fallbacks"]
    assert stats["roles"] == {"prefill": 1, "decode": 1}
    assert stats["kv_transfer"]["transfers"] >= len(uids)
    assert prefill.kv_blocks_exported > 0 and decode.kv_blocks_imported > 0
    assert common.leak_free(prefill) and common.leak_free(decode)
    # a request's trace spans both engines: the decode side adopted the
    # prefill side's traceparent from the handoff record
    spans = telemetry.get_telemetry().tracer.snapshot()
    per_trace = {}
    for s in spans:
        if s["name"] == "engine/request":
            per_trace[s["trace_id"]] = per_trace.get(s["trace_id"], 0) + 1
    assert per_trace and max(per_trace.values()) == 2
