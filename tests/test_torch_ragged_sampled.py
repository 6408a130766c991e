"""Seeded sampling in the port's ragged engine against the JAX engine, on the
CPU in fp32 with tests/torch_ragged_common.py's tiny model, sizes and
weights: a batch mixing greedy and sampled requests (temperature, top-k,
top-p, explicit and engine-assigned seeds) gives the JAX engine's streams
and H2D bytes in the plain, tiled, run-ahead and fused modes with device
state on and off, and with the multi-step scheduler with and without
self-speculation; speculative streams equal plain seeded decoding; a
sampled ``warmup()`` prepares every program a sampled run dispatches.
Every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, RCFG

from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

MODES = {"plain": {}, "tiled": {"prefill_tile": 8}, "run_ahead": {"decode_run_ahead": 4},
         "fused": {"fused_chunk": 4, "pipeline_depth": 2},
         "fused_tiled": {"fused_chunk": 4, "pipeline_depth": 2, "prefill_tile": 8}}
SCHED, SPEC = {"sched_steps": 8}, {"sched_steps": 8, "spec_draft": 4}
MAX_NEW = 8
ENGINE_SEED = 5
# per request (tests/torch_ragged_common.requests() order): greedy, seeded
# with each filter, a greedy request carrying a filter, an assigned seed
SAMPLING = ({}, dict(temperature=0.9, seed=7), dict(temperature=0.7, top_k=5, seed=11), {},
            dict(temperature=1.1, top_p=0.8), dict(temperature=0.8, top_k=20, top_p=0.9, seed=3),
            dict(top_k=3))
# every mode with device state on and off (the host-staged fused program is
# one, flat or tiled); the scheduler and speculation under every dispatch
# mode are held greedy by tests/test_torch_ragged_sched.py, and sampled they
# pick through one lane layout whatever the mode, held here on the modes
# whose turns before the scheduler differ
CASES = ([(m, ds, {}) for m in MODES for ds in (True, False) if (m, ds) != ("fused_tiled", False)]
         + [("fused", True, SCHED), ("plain", True, SPEC), ("run_ahead", True, SPEC),
            ("fused", True, SPEC)])


def _case_id(case):
    mode, ds, extra = case
    return "-".join([mode, "device" if ds else "host"]
                    + (["spec" if "spec_draft" in extra else "sched"] if extra else []))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _put_all(eng, sampling=SAMPLING):
    for (uid, prompt), kw in zip(common.requests().items(), sampling):
        eng.put(uid, prompt, max_new_tokens=MAX_NEW, **kw)


def _engine(over: dict):
    return RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)), RaggedConfig(**{**RCFG, **over}),
        dtype=torch.float32, params=params_from_numpy(common.np_params()), device="cpu",
        seed=ENGINE_SEED)


@functools.cache
def _jax_run(over: tuple):
    jcfg = jax_llama.LlamaConfig(**CFG)
    eng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx), jax_ragged.RaggedConfig(**RCFG, **dict(over)),
        dtype=jnp.float32, params=jax.tree_util.tree_map(jnp.asarray, common.np_params()),
        seed=ENGINE_SEED)
    _put_all(eng)
    return eng.generate_all(), eng.h2d_bytes, eng.dispatch_count


def _over(mode, device_state, extra) -> dict:
    return {**MODES[mode], "device_state": device_state, **extra}


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_seeded_streams_identical_to_jax(case):
    over = _over(*case)
    eng = _engine(over)
    _put_all(eng)
    got = eng.generate_all()
    want, h2d, dispatches = _jax_run(tuple(sorted(over.items())))
    assert got == want
    assert eng.h2d_bytes == h2d and eng.dispatch_count == dispatches
    assert all(len(v) == MAX_NEW for v in got.values())


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_speculation_keeps_plain_seeded_streams(mode):
    """Exact-match verification: the scheduler, with and without
    speculation, surfaces the stream plain seeded decoding does (the draw of
    token g is a function of the request's seed and g alone)."""
    base = _engine(_over(mode, False, {}))
    _put_all(base)
    want = base.generate_all()
    for extra in (SCHED, SPEC):
        eng = _engine(_over(mode, True, extra))
        _put_all(eng)
        assert eng.generate_all() == want
    # and the samples are not greedy: a seeded stream differs from its
    # greedy run
    greedy = _engine(_over(mode, False, {}))
    _put_all(greedy, [{}] * len(SAMPLING))
    assert greedy.generate_all()["r1"] != want["r1"]


def test_sampled_warmup_prepares_every_program():
    """``warmup(sampled=True, has_tk=True, has_tp=True)`` prepares the fused
    and scheduler programs a run of sampled, filtered requests dispatches,
    so it adds none (on the card: 0 captures)."""
    eng = _engine({**MODES["fused"], "device_state": True, **SCHED})
    n = eng.warmup(sampled=True, has_tk=True, has_tp=True)
    assert n == eng.warmup()  # the same family, greedy
    warmed = set(eng.programs._seen)
    _put_all(eng, [dict(temperature=0.8, top_k=9, top_p=0.9, seed=i) for i in range(7)])
    eng.generate_all()
    assert set(eng.programs._seen) == warmed
    assert {key[-3:] for key in warmed} == {(True, True, True), (False, False, False)}
