"""The prefix cache in the port's ragged engine against the JAX engine, on
the CPU in fp32 with tests/torch_ragged_common.py's tiny model and weights:
a prefix hit gives the cold run's tokens, greedy and seeded, and the JAX
engine's tokens, schedule, H2D bytes and prefix counters, in the host-staged,
device run-ahead, fused and scheduler + speculation modes (the tail prefill
after a hit of two 4-token blocks starts in the middle of an 8-token tile);
and the lifecycle cases of tests/unit/test_prefix_cache.py (refcounts under
an interleaved cancel, eviction under pool pressure, two live sequences
sharing blocks, partial blocks and the cache off) give the JAX engine's
tokens and counters. Every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch
import torch_prefix_common as pc
from torch_prefix_common import BS, MODES, PROMPT_A, PROMPT_B, SHARED

from deepspeed_tpu_torch.inference.ragged import RaggedConfig


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leak_free(eng) -> bool:
    """No live reference anywhere, and every usable block free or retained
    by the cache."""
    alloc = eng.allocator
    return (all(r == 0 for r in alloc._refs) and not eng._reserved
            and len(alloc._free) + alloc.retained_blocks == alloc.num_blocks - 1)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefix_hit_matches_cold_and_jax(mode, tmp_path):
    """Hits give the cold tokens, and the JAX engine's tokens, schedule, H2D
    bytes and prefix counters. The three requests on a new prefix (more
    than the slots left) hit exactly when the JAX engine's do: a sequence
    publishes at its release, once its dispatches in flight have drained,
    in every mode."""
    eng = pc.port_engine({**MODES[mode], **pc.TIER, "kv_tier_dir": str(tmp_path)})
    got = pc.drive(eng)
    eng._kvtier.close()
    want = pc.jax_drive(mode)["phases"]
    tokens, snap = got[0]
    assert tokens == want[0][0]
    assert snap == want[0][1]
    cold = pc.cold_tokens()
    assert {"g": tokens["g"], "s": tokens["s"]} == {"g": cold["g"], "s": cold["s"]}
    # the pair spliced the two shared blocks, and a late request on the new
    # prefix its two; the warm-up and the first of the three missed
    assert snap["prefix_hits"] >= 3 and snap["prefix_misses"] >= 2
    assert snap["prefix_tokens_reused"] >= 2 * len(SHARED) + 2 * BS
    assert cold["s"] != cold["g"]  # the seeded request really sampled
    assert leak_free(eng)


# --------------------------------------------------- lifecycle invariants
LIFECYCLE = dict(enable_prefix_cache=True, device_state=False)


def lifecycle(case: str, make) -> dict:
    """The cases of tests/unit/test_prefix_cache.py on the engine ``make``
    builds: the tokens and counters after each part. ``"pressure"``:
    distinct prompts pile up in 13 usable blocks until allocation evicts.
    ``"interleaved"``, on one engine: a prompt under one block and a
    full-prompt re-ask (no hit: the match stops a block short), two live
    sequences splicing the same cached blocks, then five requests on the
    shared prefix with one cancelled mid-flight."""
    def observe(eng, out, **extra):
        return dict(out=out, hits=eng.prefix_hits, misses=eng.prefix_misses,
                    reused=eng.prefix_tokens_reused, evictions=eng.allocator.evictions,
                    refs=list(eng.allocator._refs), retained=eng.allocator.retained_blocks,
                    free=eng.allocator.free_blocks, **extra)

    parts = []
    if case == "pressure":
        eng = make(dict(num_blocks=14, max_seqs=2, max_blocks_per_seq=8))
        rng = np.random.default_rng(7)
        out = {}
        for uid in [*range(8), "last"]:
            eng.put(uid, [int(t) for t in rng.integers(0, 97, (8,))], max_new_tokens=4)
            out.update(eng.generate_all())
        return [observe(eng, out)]
    eng = make({})
    out = {}
    for uid, prompt in enumerate(([11, 7, 3], [11, 7, 3, 96], [11, 7, 3, 96])):
        eng.put(uid, prompt, max_new_tokens=4)
        out.update(eng.generate_all())
    parts.append(observe(eng, out, cached_len=eng.cached_prefix_len(PROMPT_B)))
    eng.put("a", PROMPT_A, max_new_tokens=4)
    eng.generate_all()
    eng.put("b", PROMPT_B, max_new_tokens=6)
    eng.put("c", SHARED + [71], max_new_tokens=6)
    eng.step()  # admits both; each splices the same two cached blocks
    live = list(eng._running.values())
    shared = [live[0].blocks[:2] == live[1].blocks[:2],
              [eng.allocator._refs[b] for b in live[0].blocks[:2]]]
    parts.append(observe(eng, eng.generate_all(), shared=shared))
    for uid in range(10, 15):
        eng.put(uid, SHARED + [uid + 50, uid + 51, uid + 52], max_new_tokens=6)
    eng.step()
    eng.cancel(11)  # mid-flight: the shared blocks must survive it
    eng.generate_all()
    eng.put(19, PROMPT_B, max_new_tokens=4)
    parts.append(observe(eng, eng.generate_all()))
    return parts


@functools.cache
def _jax_lifecycle(case: str) -> list:
    return lifecycle(case, lambda over: pc.jax_engine({**LIFECYCLE, **over}))


@pytest.mark.parametrize("case", ["pressure", "interleaved"])
def test_lifecycle_matches_jax(case):
    engines = []

    def make(over):
        engines.append(pc.port_engine({**LIFECYCLE, **over}))
        return engines[-1]

    got = lifecycle(case, make)
    assert got == _jax_lifecycle(case)
    assert leak_free(engines[0])
    if case == "pressure":
        assert got[0]["evictions"] > 0 and len(got[0]["out"]["last"]) == 4
        return
    partial, shared, cancel = got
    # under one block, and a re-ask capped one block short: no hit
    assert partial["hits"] == 0 and partial["misses"] == 3 and partial["cached_len"] == 0
    assert shared["shared"] == [True, [2, 2]] and shared["hits"] == 2
    assert len(cancel["out"][19]) == 4 and cancel["hits"] > shared["hits"] + 1


def test_cache_off_stays_cold():
    eng = pc.port_engine({})
    eng.put(0, PROMPT_A, max_new_tokens=4)
    eng.generate_all()
    eng.put(1, PROMPT_B, max_new_tokens=4)
    eng.generate_all()
    assert eng.prefix_hits == eng.prefix_misses == 0
    assert eng.allocator.cached_blocks == eng.allocator.retained_blocks == 0
    assert eng.cached_prefix_len(PROMPT_B) == 0


def test_cached_prefix_len_and_stale_probe():
    """The advisory probe reports the block-aligned splice, and a placement
    credit the splice does not meet is counted."""
    eng = pc.port_engine(dict(enable_prefix_cache=True))
    eng.put("warm", PROMPT_A, max_new_tokens=4)
    eng.generate_all()
    assert eng.cached_prefix_len(PROMPT_B) == 2 * BS
    assert eng.cached_prefix_len(PROMPT_A) == 2 * BS  # capped short of the prompt
    eng.put("ok", PROMPT_B, max_new_tokens=4, expected_cached_tokens=2 * BS)
    eng.put("stale", PROMPT_B, max_new_tokens=4, expected_cached_tokens=3 * BS)
    eng.generate_all()
    assert eng.prefix_stale_probes == 1 and eng.prefix_hits == 2


def test_refused_fields_name_their_items():
    # low-bit serving is ported (tests/test_torch_kvquant.py): a bad
    # grammar raises as in the reference
    assert pc.port_engine(dict(quant="int8", enable_prefix_cache=True))._kvq_name == "int8"
    with pytest.raises(ValueError, match="unknown component"):
        pc.port_engine(dict(quant="int3"))
    with pytest.raises(NotImplementedError, match="item 14"):
        pc.port_engine(dict(headroom_admission=True))
    assert RaggedConfig().enable_prefix_cache is False


def test_prefix_listener_hears_publish_and_evict():
    """``set_prefix_listener`` wires a cluster index to the allocator: it
    hears each published chain key, and each eviction before the block is
    reused."""
    events = []

    class Listener:
        def on_publish(self, key):
            events.append(("publish", len(key[1])))

        def on_evict(self, key):
            events.append(("evict", len(key[1])))

    eng = pc.port_engine(dict(enable_prefix_cache=True, num_blocks=13))
    eng.set_prefix_listener(Listener())
    eng.put("warm", PROMPT_A, max_new_tokens=4)
    eng.generate_all()
    assert events == [("publish", BS)] * 2
    pc.churn(eng)
    assert ("evict", BS) in events and eng.allocator.evictions == events.count(("evict", BS))
