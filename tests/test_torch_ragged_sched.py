"""The port's device-side multi-step scheduler (``RaggedConfig(sched_steps=...)``)
and self-speculative decoding (``spec_draft``, ``spec_ngram``) against the
JAX package, on the CPU in fp32: the draft, acceptance and lane-layout
functions on seeded random inputs and on tests/unit/test_spec_decode.py's
hand cases; the engine in the plain, tiled, run-ahead and fused modes with
the scheduler alone and with speculation (tokens, schedule, H2D bytes and
the speculation counters identical to the JAX engine's); EOS inside a
scheduler chunk; cancel while one is in flight; the host-staged kill switch;
the configuration rules; ``warmup()``; and the schedule of the reference
bench's serving configuration with ``sched_steps=16``, which chip_smoke.py
holds the card to. Sizes and weights are tests/torch_ragged_common.py's; the
JAX runs are cached per process. Every comparison is exact.

On the CPU every scheduler program runs eagerly (a Python loop on the
program's own predicate); its graph form is held in tests/test_torch_cuda.py.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, RCFG

import chip_smoke
from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.inference import sampling as jax_sampling
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import paged as jax_paged
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama, paged
from deepspeed_tpu_torch.models.convert import params_from_numpy

# tests/unit/test_spec_decode.py's dispatch modes
MODES = {"plain": {}, "tiled": {"prefill_tile": 8}, "run_ahead": {"decode_run_ahead": 4},
         "fused": {"fused_chunk": 4, "pipeline_depth": 2}}
SCHED, SPEC = {"sched_steps": 8}, {"sched_steps": 8, "spec_draft": 4}
# long enough that greedy streams of the random model fall into loops the
# prompt-lookup draft predicts, so drafts are accepted
MAX_NEW = 20
LENS = (3, 4, 5, 8, 9, 13, 17)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(device_state=True, eos_token_id=None, **over):
    return RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)),
        RaggedConfig(**{**RCFG, "device_state": device_state, **over}),
        dtype=torch.float32, params=params_from_numpy(common.np_params()), device="cpu",
        eos_token_id=eos_token_id)


def _run(eng, requests, max_new=MAX_NEW, **put):
    for uid, prompt in requests.items():
        eng.put(uid, prompt, max_new_tokens=max_new, **put)
    return eng.generate_all()


def _leak_free(eng):
    return (eng.allocator.free_blocks == eng.cfg.num_blocks - 1 and eng._reserved == 0
            and len(eng._free_slots) == eng.cfg.max_seqs and not eng._running
            and not eng._pending and not eng._inflight_chunks and not eng.block_tables.any())


@functools.cache
def _jax_run(over: tuple):
    """The JAX engine's run of ``LENS`` x ``MAX_NEW`` under ``RCFG`` + ``over``:
    tokens and counters."""
    jcfg = jax_llama.LlamaConfig(**CFG)
    eng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx), jax_ragged.RaggedConfig(**RCFG, **dict(over)),
        dtype=jnp.float32, params=jax.tree_util.tree_map(jnp.asarray, common.np_params()))
    tokens = _run(eng, common.requests(lens=LENS))
    return tokens, dict(dispatches=eng.dispatch_count, scheduled=eng.tokens_scheduled,
                        padded=eng.tokens_padded, h2d_bytes=eng.h2d_bytes,
                        proposed=eng.spec_proposed, accepted=eng.spec_accepted)


# ------------------------------------------------------------- functions
def _random_case(seed: int):
    rng = np.random.default_rng(seed)
    t, s, d = 6, 40, int(rng.integers(1, 6))
    return dict(rng=rng, t=t, d=d, ngram=int(rng.integers(1, 4)),
                hist=rng.integers(0, 4, (t, s)).astype(np.int32),
                pos=rng.integers(0, s, t).astype(np.int32),
                picked=rng.integers(0, 3, (t, d + 1)).astype(np.int32),
                draft=rng.integers(0, 3, (t, d)).astype(np.int32),
                budget=rng.integers(-1, d + 3, t).astype(np.int32),
                eos=rng.integers(-1, 3, t).astype(np.int32),
                live=rng.random(t) < 0.7, cap=rng.integers(0, 50, t).astype(np.int32),
                slots=rng.integers(0, 4, t).astype(np.int32))


def _same(jax_out, torch_out):
    return all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jax_out, torch_out))


@pytest.mark.parametrize("fn", ["propose_ngram_drafts", "accept_drafts",
                                "speculative_lane_layout"])
def test_functions_match_jax_on_random_inputs(fn):
    """Each function against the JAX one on 40 seeded random cases (small
    token alphabets, so suffixes match, drafts agree, EOS strikes)."""
    for seed in range(40):
        c = _random_case(seed)
        tt = {k: torch.from_numpy(v) for k, v in c.items() if isinstance(v, np.ndarray)}
        jj = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
        if fn == "propose_ngram_drafts":
            want = jax_sampling.propose_ngram_drafts(jj["hist"], jj["pos"], c["ngram"], c["d"])
            got = sampling.propose_ngram_drafts(tt["hist"], tt["pos"], c["ngram"], c["d"])
        elif fn == "accept_drafts":
            args = ("draft", "picked", "budget", "eos")
            want = jax_sampling.accept_drafts(*(jj[a] for a in args))
            got = sampling.accept_drafts(*(tt[a] for a in args))
        else:
            args = ("pos", "draft", "pos", "live", "cap", "slots")
            want = jax_paged.speculative_lane_layout(*(jj[a] for a in args), 9)
            got = paged.speculative_lane_layout(*(tt[a] for a in args), 9)
            assert got[0].dtype == torch.int32
        assert _same(want, got), (fn, seed)


def test_propose_ngram_drafts_most_recent_match():
    """tests/unit/test_spec_decode.py's hand case: the most recent match of
    the suffix supplies the draft; a row without one drafts zeros."""
    hist = [[5, 6, 7, 8, 0, 5, 6, 9, 9, 9, 5, 6], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]]
    pos = [11, 5]
    draft, matched = sampling.propose_ngram_drafts(
        torch.tensor(hist, dtype=torch.int32), torch.tensor(pos, dtype=torch.int32), 2, 3)
    assert matched.tolist() == [True, False]
    assert draft.tolist() == [[9, 9, 9], [0, 0, 0]]
    assert _same(jax_sampling.propose_ngram_drafts(jnp.asarray(hist, jnp.int32),
                                                   jnp.asarray(pos, jnp.int32), 2, 3),
                 (draft, matched))


def test_accept_drafts_prefix_budget_eos():
    """tests/unit/test_spec_decode.py's hand case: the accepted prefix plus
    the bonus pick, clamped by the budget, cut after an EOS."""
    draft = [[4, 5, 6]] * 3
    picked = [[4, 5, 9, 7], [4, 5, 6, 7], [4, 99, 6, 7]]
    budget, eos = [4, 2, 4], [-1, -1, 99]
    n_emit, n_acc = sampling.accept_drafts(*(torch.tensor(x, dtype=torch.int32)
                                             for x in (draft, picked, budget, eos)))
    assert n_emit.tolist() == [3, 2, 2] and n_acc.tolist() == [2, 2, 1]
    assert _same(jax_sampling.accept_drafts(*(jnp.asarray(x, jnp.int32)
                                              for x in (draft, picked, budget, eos))),
                 (n_emit, n_acc))


# ---------------------------------------------------------------- engine
PARITY = [(mode, name) for mode in MODES for name in ("sched", "spec")
          if name == "spec" or mode in ("plain", "fused")]


@pytest.mark.parametrize("mode,name", PARITY, ids=[f"{m}-{n}" for m, n in PARITY])
def test_engine_identical_to_jax(mode, name):
    """Tokens, dispatches, scheduled and padded tokens, H2D bytes and the
    speculation counters all equal the JAX engine's; the tokens equal the
    host-staged engine's without the scheduler; scheduler programs ran, and
    with speculation drafts were accepted."""
    over = {**MODES[mode], **(SPEC if name == "spec" else SCHED)}
    want, counts = _jax_run(tuple(sorted(over.items())))
    eng = _engine(**over)
    got = _run(eng, common.requests(lens=LENS))
    assert got == want
    assert got == _run(_engine(device_state=False), common.requests(lens=LENS))
    assert dict(dispatches=eng.dispatch_count, scheduled=eng.tokens_scheduled,
                padded=eng.tokens_padded, h2d_bytes=eng.h2d_bytes,
                proposed=eng.spec_proposed, accepted=eng.spec_accepted) == counts
    assert eng.sched_dispatches > 0 and eng.sched_iterations > 0
    assert {key[0] for key in eng.programs._seen} >= {"sched"}
    if name == "spec":
        assert 0 < counts["accepted"] <= counts["proposed"]
    assert _leak_free(eng)


@pytest.mark.parametrize("over", [SCHED, SPEC, {**SPEC, **MODES["fused"]}],
                         ids=["sched", "spec", "fused-spec"])
def test_eos_mid_chunk_truncates(over):
    """A row that picks its EOS inside a scheduler chunk retires on the
    device: nothing after the EOS surfaces, and every stream is the
    host-staged engine's."""
    reqs = common.requests(5, (5, 11, 23))
    ref = _run(_engine(device_state=False), reqs, 10)
    eos = int(ref["r1"][2])
    want = _run(_engine(device_state=False, eos_token_id=eos), reqs, 10)
    eng = _engine(eos_token_id=eos, **over)
    got = _run(eng, reqs, 10)
    assert got == want
    assert got["r1"][-1] == eos and len(got["r1"]) < 10
    assert eng.sched_dispatches > 0
    assert _leak_free(eng)


@pytest.mark.parametrize("spec", [0, 4])
def test_cancel_during_inflight_sched_chunk(spec):
    """cancel() while a scheduler program that references the request is in
    flight: it retires through the deferred release, its slot and blocks are
    recycled, and the other request's stream is that of a run without it."""
    reqs = common.requests(29, (11, 23))
    want = None
    for with_cancel in (False, True):
        eng = _engine(sched_steps=8, spec_draft=spec)
        eng.put("keep", reqs["r0"], max_new_tokens=8)
        if with_cancel:
            eng.put("dead", reqs["r1"], max_new_tokens=8)
        for _ in range(50):
            eng.step()
            if any(r["kind"] == "sched" for r in eng._pending):
                break
        assert any(r["kind"] == "sched" for r in eng._pending)
        if with_cancel:
            assert eng.get_request("dead").refs >= 1
            assert eng.cancel("dead")
            eng._sweep_aborts()  # the release waits for the dispatch in flight
            assert eng.get_request("dead").slot >= 0
        out = eng.generate_all()
        if with_cancel:
            assert eng.get_request("dead").status == "cancelled"
            assert len(out["dead"]) < 8
        if want is None:
            want = out["keep"]
        else:
            assert out["keep"] == want
        assert _leak_free(eng)


def test_kill_switch_leaves_scheduler_inert():
    """``device_state=False`` leaves the scheduler and speculation inert, as
    in the JAX engine: the host-staged engine's tokens and dispatches, no
    scheduler program, no draft."""
    reqs = common.requests(lens=LENS)
    base = _engine(device_state=False)
    want = _run(base, reqs)
    for over in (SPEC, {**SPEC, **MODES["fused"]}):
        killed = _engine(device_state=False, **over)
        assert _run(killed, reqs) == want
        if not over.get("fused_chunk"):
            assert killed.dispatch_count == base.dispatch_count
        assert killed.sched_dispatches == 0 and killed.spec_proposed == 0
        assert not any(key[0] == "sched" for key in killed.programs._seen)


def test_config_validation():
    """Off by default; the reference's rules with the reference's messages
    (each message stands in deepspeed_tpu/inference/ragged.py)."""
    cfg = RaggedConfig()
    assert (cfg.sched_steps, cfg.spec_draft, cfg.spec_ngram) == (0, 0, 3)
    source = Path(jax_ragged.__file__).read_text()
    for over, message in (({"sched_steps": 1}, "sched_steps must be 0 (off) or >= 2"),
                          ({"sched_steps": -2}, "sched_steps must be 0 (off) or >= 2"),
                          ({"spec_draft": 4}, "spec_draft requires sched_steps >= 2"),
                          ({"sched_steps": 8, "spec_draft": 4, "spec_ngram": 0},
                           "spec_ngram must be >= 1")):
        assert f'raise ValueError("{message}")' in source
        with pytest.raises(ValueError, match=re.escape(message)):
            _engine(**over)
    _engine(sched_steps=2, spec_ngram=0)  # the n-gram is read only with drafts


def test_warmup_prepares_the_scheduler_family_and_leaves_state():
    """warmup() runs each scheduler program once on an all-scratch staging
    buffer: it returns the size of the JAX engine's family (k in 1, 2, 4, 8
    at the one token bucket that holds 3 rows and the one table width: 4,
    plus the fused family when fused chunks are on), and changes no slot
    row, history row, KV block, table or byte count but the scratch ones;
    the warmed engine then serves the host-staged engine's tokens."""
    eng = _engine(**SPEC)
    early = common.requests(2, (5,))["r0"]
    eng.put("early", early, max_new_tokens=5)
    eng.step()  # live state the scratch runs must not touch
    before = ([t.clone() for t in eng._dev_state], eng._hist_dev.clone(),
              eng.cache["k"].clone(), eng.cache["v"].clone(), eng._bt_dev.clone(),
              eng.block_tables.copy(), eng.allocator.free_blocks, eng._reserved,
              eng.h2d_bytes, eng.stage_bytes, eng.dispatch_count, eng.tokens_scheduled)
    assert eng.warmup() == 4
    assert {key for key in eng.programs._seen if key[0] == "sched"} == {
        ("sched", k, 4, RCFG["max_blocks_per_seq"], 4) for k in (1, 2, 4, 8)}
    state, hist, k, v, bt, bt_host, *counts = before
    for a, b in zip(state, eng._dev_state):
        assert torch.equal(a[:-1], b[:-1])
    assert torch.equal(hist[:-1], eng._hist_dev[:-1])
    assert torch.equal(k[:, 1:], eng.cache["k"][:, 1:])
    assert torch.equal(v[:, 1:], eng.cache["v"][:, 1:])
    assert torch.equal(bt, eng._bt_dev) and (bt_host == eng.block_tables).all()
    assert counts == [eng.allocator.free_blocks, eng._reserved, eng.h2d_bytes,
                      eng.stage_bytes, eng.dispatch_count, eng.tokens_scheduled]
    reqs = common.requests(17, (4, 9, 6))
    got = _run(eng, reqs, 6)
    assert {uid: got[uid] for uid in reqs} == _run(_engine(device_state=False), reqs, 6)
    assert _leak_free(eng)
    assert _engine(**SPEC, **MODES["fused"]).warmup() == 15 + 4
    assert _engine(device_state=False, **SPEC, **MODES["fused"]).warmup() == 15


class _NoCompile:
    """Stands for a jitted program in the JAX engine's warmup(): lowering
    and compiling it does nothing, so warmup() only counts its family."""

    def lower(self, *args, **kw):
        return self

    def compile(self):
        return self


BENCH_RAGGED = dict(device_state=True, decode_run_ahead=chip_smoke.RUN_AHEAD, fused_chunk=16,
                    pipeline_depth=3, sched_steps=chip_smoke.SCHED_STEPS)
BENCH_MODEL = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=1,
                   num_heads=4, num_kv_heads=2, max_seq_len=1024)


def test_bench_sched_schedule_matches_jax():
    """The reference bench's serving configuration (``chip_smoke.ENGINE``,
    run-ahead 48, fused chunks of 16, three in flight) with
    ``sched_steps=16`` over chip_smoke.py's 32 x 48 workload: with no EOS and
    greedy picks the schedule does not depend on the weights, so a 1-layer
    tiny model gives the 8B run's. Both engines: the same tokens, the
    schedule chip_smoke.py pins (``SCHED_SCHEDULE``: dispatches, scheduled and
    padded tokens), the same warmup family size (``SCHED_WARMUP_PROGRAMS``);
    the port's split into fused and scheduler dispatches is
    ``SCHED_DISPATCHES``."""
    prompts = chip_smoke.requests(np, BENCH_MODEL["vocab_size"])
    jcfg = jax_llama.LlamaConfig(**BENCH_MODEL)
    params = jax.tree_util.tree_map(np.array, jax_llama.init_params(jcfg, jax.random.PRNGKey(3)))
    jeng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx),
        jax_ragged.RaggedConfig(**chip_smoke.ENGINE, **BENCH_RAGGED), dtype=jnp.float32,
        params=jax.tree_util.tree_map(jnp.asarray, params))
    peng = RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**BENCH_MODEL)),
        RaggedConfig(**chip_smoke.ENGINE, **BENCH_RAGGED), dtype=torch.float32,
        params=params_from_numpy(params), device="cpu")
    got = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        for i, p in enumerate(prompts):
            eng.put(i, p, max_new_tokens=chip_smoke.MAX_NEW)
        got[name] = eng.generate_all()
        assert ((eng.dispatch_count, eng.tokens_scheduled, eng.tokens_padded)
                == chip_smoke.SCHED_SCHEDULE), name
    assert got["port"] == got["jax"]
    assert all(len(v) == chip_smoke.MAX_NEW for v in got["port"].values())
    assert (peng.dispatch_count - peng.sched_dispatches, peng.sched_dispatches) == \
        chip_smoke.SCHED_DISPATCHES
    jeng._get_dev_fused = jeng._get_dev_sched = lambda *a, **kw: _NoCompile()
    assert jeng.warmup() == chip_smoke.SCHED_WARMUP_PROGRAMS
    assert peng.warmup() == chip_smoke.SCHED_WARMUP_PROGRAMS
    assert _leak_free(peng)
