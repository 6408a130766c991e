"""KV tiering in the port (``inference/kvtier.py`` and the ragged engine's
tier side) against the JAX package, on the CPU in fp32 with
tests/torch_ragged_common.py's tiny model and weights. The cases of
tests/unit/test_kvtier.py: framing, corruption and truncation (the bytes
equal the JAX package's); the restore cost model's edges; the host arena's
LRU; the disk tier's atomic records, budget and torn-file sweep (a record
one package writes, the other reads); notify-before-free; demotion,
spill and promotion in the host-staged, device run-ahead, fused and
scheduler + speculation modes with the JAX engine's counters and the cold
tokens; a prefetch hit, an abandoned prefetch and a declined restore, each
with the cold tokens.
"""

import os
import threading

import numpy as np
import pytest
import torch
import torch_prefix_common as pc
from torch_prefix_common import MODES, PROMPT_A, PROMPT_B

from deepspeed_tpu.inference import kvtier as jax_kvtier
from deepspeed_tpu_torch.inference import kvtier
from deepspeed_tpu_torch.inference.ragged import BlockedAllocator


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- framing
def test_framing_matches_jax():
    a, b = kvtier.frame_bytes(b"alpha"), kvtier.frame_bytes(b"")
    assert a == jax_kvtier.frame_bytes(b"alpha") and b == jax_kvtier.frame_bytes(b"")
    body, off = kvtier.unframe_bytes(a + b)
    assert body == b"alpha" and kvtier.unframe_bytes(a + b, off) == (b"", len(a + b))
    assert (kvtier.HANDOFF_MAGIC, kvtier.RECORD_MAGIC) == (jax_kvtier.HANDOFF_MAGIC,
                                                           jax_kvtier.RECORD_MAGIC)


@pytest.mark.parametrize("damage", ["flip", "truncate_body", "truncate_header"])
def test_framing_rejects_damage(damage):
    buf = bytearray(kvtier.frame_bytes(b"payload bytes"))
    if damage == "flip":
        buf[-3] ^= 0x01
    elif damage == "truncate_body":
        buf = buf[:-1]
    else:
        buf = buf[:20]
    for mod in (kvtier, jax_kvtier):
        with pytest.raises(ValueError, match="torn|corrupt"):
            mod.unframe_bytes(bytes(buf))


def test_restore_cost_model_edges_match_jax():
    cases = [(0, 64, 100.0, 5e4), (-1, 64, 100.0, 5e4), (8, 64, -1.0, 5e4), (8, 64, 0.0, 5e4),
             (8, 64, 100.0, 0.0), (8, 1250, 1.0, 1e5), (8, 1249, 1.0, 1e5),
             (32, 131072, 100.0, 5e4), (32, 131072, 8.0, 5e4), (32, 16384, 8.0, 5e4)]
    got = [kvtier.restore_beats_prefill(*c) for c in cases]
    assert got == [jax_kvtier.restore_beats_prefill(*c) for c in cases]
    # zero or unknown never restores; an exact tie (1250 B at 1 Gbit/s vs
    # 1e5 tokens/s: both 10 us a token) prefers prefill
    assert got[:6] == [False] * 6 and got[6]
    # Llama-3-8B bf16 (131072 B a token): the host link restores, disk not;
    # 2 fp32 layers (16384 B a token) restore from disk too
    assert got[7:] == [True, False, True]


def test_host_tier_lru_matches_jax():
    logs = []
    for mod in (kvtier, jax_kvtier):
        h = mod.HostTier(2)
        log = [h.put("a", np.arange(4)), h.put("b", np.arange(4))]
        h.get("a")                       # a -> MRU
        log.append([k for k, _ in h.put("c", np.arange(4))])  # sheds b
        log.append(h.put("a", np.arange(8)))  # re-put touches, sheds nothing
        log.append([k for k, _ in h.put("d", np.arange(4))])  # sheds c
        log += [sorted(h._store), h.nbytes]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][2] == ["b"] and logs[0][4] == ["c"] and logs[0][5] == ["a", "d"]


def test_disk_tier_atomic_budget_sweep_across_packages(tmp_path):
    d = str(tmp_path / "kv")
    disk = kvtier.DiskTier(d, budget_blocks=2)
    payload = {"k": np.arange(6, dtype=np.float32).reshape(1, 1, 6),
               "v": np.ones((1, 1, 6), np.float32)}
    assert disk.put(("root", (1, 2)), payload) and disk.put("k2", payload)
    assert not any(".tmp." in n for n in os.listdir(d))  # committed by os.replace
    # the JAX package reads the port's record (fp32 numpy payload), and back
    got = jax_kvtier.DiskTier(d, budget_blocks=2).get(("root", (1, 2)))
    assert all(np.array_equal(got[n], payload[n]) for n in payload)
    disk.put("k3", payload)  # past the budget: the oldest record goes
    assert ("root", (1, 2)) not in disk and len(disk) == 2
    # debris of a crash: a temp file, a torn record, a record with bad bytes
    open(os.path.join(d, ".x.kvb.tmp.1"), "wb").write(b"half")
    good = open(disk._path(kvtier._key_digest("k3")), "rb").read()
    open(os.path.join(d, "torn.kvb"), "wb").write(good[:-5])
    open(os.path.join(d, "bad.kvb"), "wb").write(good[:-1] + bytes([good[-1] ^ 1]))
    fresh = kvtier.DiskTier(d, budget_blocks=2)
    assert fresh.sweep_removed == 3 and len(fresh) == 2
    assert np.array_equal(fresh.get("k3")["v"], payload["v"])
    assert fresh.get("absent") is None


class _Listener:
    def __init__(self, alloc):
        self.alloc, self.events = alloc, []

    def on_publish(self, key):
        pass

    def on_evict(self, key):
        self.events.append(("evict", key, len(self.alloc._free)))

    def on_demote(self, key):
        self.events.append(("demote", key, len(self.alloc._free)))


def _raise(block, key):
    raise RuntimeError("gather failed")


@pytest.mark.parametrize("hook,event", [(lambda b, k: True, "demote"),
                                        (lambda b, k: False, "evict"), (_raise, "evict")],
                         ids=["captured", "declined", "raising"])
def test_demote_notified_before_block_freed(hook, event):
    a = BlockedAllocator(3)  # 2 usable
    a.listener = lst = _Listener(a)
    a.demote_hook = hook
    blocks = a.allocate(2)
    a.publish(blocks[0], "key0")
    a.free(blocks)  # key0 retained, the other block free
    a.allocate(2)   # evicts key0
    # one block was free before the eviction: the evicted id had not joined it
    assert lst.events[-1] == (event, "key0", 1) and a.evictions == 1


# ---------------------------------------------------------- engine tiers
@pytest.mark.parametrize("mode", list(MODES))
def test_demote_promote_matches_jax(mode, tmp_path):
    eng = pc.port_engine({**MODES[mode], **pc.TIER, "kv_tier_dir": str(tmp_path)})
    got = pc.drive(eng)
    eng._kvtier.close()
    tokens, snap = got[1]
    want_tokens, want = pc.jax_drive(mode)["phases"][1]
    assert tokens == want_tokens and snap == want
    cold = pc.cold_tokens()
    assert tokens == {"g2": cold["g"], "s2": cold["s"]}
    assert snap["demotions"] > 0 and snap["spills"] > 0
    assert snap["promotions_host"] + snap["promotions_disk"] > 0
    assert snap["prefix_hits"] == got[0][1]["prefix_hits"] + 2


def _tiered(tmp_path, **over):
    eng = pc.port_engine({**pc.TIER, "kv_tier_host_blocks": 2, "kv_tier_dir": str(tmp_path),
                          **over})
    eng.put("warm", PROMPT_A, max_new_tokens=6)
    eng.generate_all()
    pc.churn(eng, n=8)
    return eng


@pytest.mark.parametrize("case", ["prefetch_hit", "prefetch_abandoned", "declined"])
def test_restore_paths_keep_cold_tokens(case, tmp_path):
    """A prefetch that landed, one that admission outran (the synchronous
    restore covers for it), and a restore the cost model declines (the
    request re-prefills): each gives the JAX engine's cold tokens."""
    over = dict(kv_tier_host_gbps=1e-9, kv_tier_disk_gbps=1e-9) if case == "declined" else {}
    eng = _tiered(tmp_path, **over)
    store = eng._kvtier
    assert eng.kv_tier_stats()["spills"] > 0
    gate = threading.Event()
    if case == "prefetch_abandoned":
        store._stall_for_test = gate  # the worker parks: admission outruns it
    if case != "declined":
        assert eng.tier_prefetch_async(PROMPT_B)
    if case == "prefetch_hit":
        assert store.wait_idle(10.0)
    eng.put("g", PROMPT_B, max_new_tokens=pc.MAX_NEW)
    got = eng.generate_all()["g"]
    gate.set()
    st = eng.kv_tier_stats()
    store.close()
    assert got == pc.jax_cold()["g"]
    if case == "prefetch_hit":
        assert (st["prefetch_hits"], st["prefetch_abandoned"]) == (1, 0)
        assert st["promotions"] >= 2
    elif case == "prefetch_abandoned":
        assert (st["prefetch_hits"], st["prefetch_abandoned"]) == (0, 1)
        assert st["promotions"] >= 2
    else:
        assert st["restore_declined"] > 0 and st["promotions"] == 0
        assert eng.prefix_hits == 0


def test_tier_config_gates(tmp_path):
    assert pc.ragged.RaggedConfig().kv_tier is False
    with pytest.raises(ValueError, match="prefix_cache"):
        pc.port_engine(dict(kv_tier=True))
    with pytest.raises(ValueError, match="kv_tier_host_blocks"):
        pc.port_engine(dict(enable_prefix_cache=True, kv_tier=True, kv_tier_host_blocks=0))
    eng = pc.port_engine(dict(enable_prefix_cache=True))
    assert eng._kvtier is None and eng.kv_tier_stats() is None
    assert eng.allocator.demote_hook is None
    assert not eng.tier_prefetch_async(PROMPT_B)
