"""Set-up shared by the port's prefix-cache, KV-tier and handoff tests
(tests/test_torch_prefix_cache.py, test_torch_kvtier.py,
test_torch_handoff.py): tests/torch_ragged_common.py's model, sizes and
weights, the prompts of tests/unit/test_prefix_cache.py, the dispatch modes,
and the JAX engine's runs of the shared workload, cached per process (a
pytest-xdist worker that runs tests of several of these files does each
once); callers must not modify what these functions return.

The workload (``drive``), on a 13-block pool with tiering on (a 4-block host
arena spilling to a 32-record disk tier): a warm-up request publishes
PROMPT_A's blocks; a greedy and a seeded request on PROMPT_B splice its two
shared blocks (the prefix hit), beside three requests on a new shared prefix, more than
the slots left, the late ones hitting as the first publishes; distinct
single-use prompts churn the pool, which demotes the published blocks down
the tiers; the same two requests again promote them back and hit once
more.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, RCFG

from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference import ragged
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

BS = RCFG["block_size"]  # 4: the prompts below are built around it
SHARED = [11, 7, 3, 5, 2, 13, 17, 19]  # two full blocks
PROMPT_A = SHARED + [23, 29, 31]       # warms the cache
PROMPT_B = SHARED + [37, 41]           # hits both shared blocks
STAGGERED = [21, 22, 23, 24, 25, 26, 27, 28]  # a prefix first seen by 3 requests at once
MAX_NEW = 8
SAMPLED = dict(temperature=0.9, top_k=20, seed=123)
# the four dispatch modes: host-staged (tiled, so a tail starts mid-tile),
# device run-ahead, fused chunks, and the scheduler with speculation
MODES = {"host": dict(device_state=False, prefill_tile=8),
         "run_ahead": dict(decode_run_ahead=4),
         "fused": dict(fused_chunk=4, pipeline_depth=2),
         "spec": dict(sched_steps=2, spec_draft=1)}
TIER = dict(enable_prefix_cache=True, num_blocks=13, kv_tier=True, kv_tier_host_blocks=4,
            kv_tier_disk_blocks=32)
# what a snapshot compares: the schedule, H2D bytes and prefix counters
COUNTERS = ("dispatch_count", "tokens_scheduled", "tokens_padded", "h2d_bytes", "prefix_hits",
            "prefix_misses", "prefix_tokens_reused", "prefix_stale_probes")
TIER_STATS = ("demotions", "spills", "spill_drops", "promotions_host", "promotions_disk",
              "promoted_admissions_host", "promoted_admissions_disk", "restore_declined",
              "host_blocks", "disk_blocks")


def churn(eng, n=6, max_new=4):
    """Distinct single-use prompts that force LRU eviction (with tiering,
    demotion) of earlier published blocks."""
    for i in range(n):
        eng.put(f"churn{i}", [(50 + i * 7 + j) % 97 for j in range(9)], max_new_tokens=max_new)
        eng.generate_all()


def put_pair(eng, suffix="", prompt=PROMPT_B, **kw):
    """A greedy and a seeded request on ``prompt``: uids g<suffix>, s<suffix>."""
    eng.put("g" + suffix, prompt, max_new_tokens=MAX_NEW, **kw)
    eng.put("s" + suffix, prompt, max_new_tokens=MAX_NEW, **SAMPLED, **kw)


def snapshot(eng) -> dict:
    snap = {name: getattr(eng, name) for name in COUNTERS}
    snap["evictions"] = eng.allocator.evictions
    stats = eng.kv_tier_stats()
    if stats is not None:
        snap.update({name: stats[name] for name in TIER_STATS})
    return snap


def drive(eng) -> list:
    """The shared workload (module docstring): [(tokens, snapshot)] after
    the prefix hits and after the promotion."""
    eng.put("warm", PROMPT_A, max_new_tokens=6)
    eng.generate_all()
    put_pair(eng)
    # beside the pair, more requests on a new prefix than the slots left:
    # whether the late ones hit depends on when the first one publishes,
    # which is at its release, once its dispatches have drained
    for u in range(3):
        eng.put(f"q{u}", STAGGERED + [60 + u, 61 + u], max_new_tokens=MAX_NEW)
    out = eng.generate_all()
    phases = [({u: out[u] for u in ("g", "s", "q0", "q1", "q2")}, snapshot(eng))]
    churn(eng)
    put_pair(eng, "2")
    out = eng.generate_all()
    phases.append(({u: out[u] for u in ("g2", "s2")}, snapshot(eng)))
    return phases


def port_engine(over: dict, params=None):
    return ragged.RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)), ragged.RaggedConfig(**{**RCFG, **over}),
        dtype=torch.float32, params=params or params_from_numpy(common.np_params()),
        device="cpu")


def jax_engine(over: dict):
    jcfg = jax_llama.LlamaConfig(**CFG)
    return jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx), jax_ragged.RaggedConfig(**{**RCFG, **over}),
        dtype=jnp.float32, params=jax.tree_util.tree_map(jnp.asarray, common.np_params()))


def handoff_prefill(eng, uids=("hg", "hs")) -> dict:
    """Prefill-stage (``handoff=True``) greedy and seeded requests on
    PROMPT_B, run to their first token and exported: {uid: record bytes}."""
    eng.put(uids[0], PROMPT_B, max_new_tokens=MAX_NEW, handoff=True)
    eng.put(uids[1], PROMPT_B, max_new_tokens=MAX_NEW, handoff=True, **SAMPLED)
    eng.generate_all()
    return {u: eng.export_handoff(u).to_bytes() for u in uids}


@functools.cache
def port_records(mode: str) -> tuple[dict, int]:
    """The port's handoff records of uids pg, ps (``mode``, no cache) as
    bytes, and the blocks it exported."""
    eng = port_engine(MODES[mode])
    return handoff_prefill(eng, ("pg", "ps")), eng.kv_blocks_exported


@functools.cache
def jax_drive(mode: str) -> dict:
    """The JAX engine's run in ``mode`` with ``TIER``: ``drive`` (``phases``),
    then, on the same engine, its own handoff records of uids hg, hs
    (``records``, after a prefix hit) and the tokens it resumes from the
    port's records (``resumed``), with its block counts. Computed once a
    test run (tests/test_torch_handoff.py, test_torch_kvtier.py and
    test_torch_prefix_cache.py each ask for every mode)."""
    return common.shared(_jax_drive, mode)


def _jax_drive(mode: str) -> dict:
    with tempfile.TemporaryDirectory() as d:
        eng = jax_engine({**MODES[mode], **TIER, "kv_tier_dir": d})
        try:
            res = dict(phases=drive(eng), records=handoff_prefill(eng))
            for buf in port_records(mode)[0].values():
                assert eng.import_handoff(jax_ragged.KVHandoff.from_bytes(buf))
            out = eng.generate_all()
            res.update(resumed={u: out[u] for u in ("pg", "ps")},
                       exported=eng.kv_blocks_exported, imported=eng.kv_blocks_imported)
            return res
        finally:
            eng._kvtier.close()


def jax_cold() -> dict:
    """The JAX engine's tokens of the greedy and seeded requests on
    PROMPT_B (spliced, which the tests hold equal to cold): {"g", "s"}."""
    tokens = jax_drive("host")["phases"][0][0]
    return {"g": tokens["g"], "s": tokens["s"]}


@functools.cache
def cold_tokens() -> dict:
    """The port's cold run of the greedy and seeded requests on PROMPT_B
    (prefix cache off)."""
    eng = port_engine({})
    put_pair(eng)
    return eng.generate_all()
