"""The port's fused mixed chunks (``RaggedConfig(fused_chunk=..., pipeline_depth=...)``)
on the CPU, fp32: the greedy tests of tests/unit/test_ragged_fused.py on the
port, each with device-resident state and on the host-staged path, held to
the port's own engine without fused chunks (tests/test_torch_ragged_device.py
holds the fused modes to the JAX engine at the test sizes); ``warmup()``;
and the schedule of the reference bench's serving configuration
(``chip_smoke.ENGINE`` with ``fused_chunk=16, pipeline_depth=3``) against
the JAX engine's, on a 1-layer tiny model. Every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, RCFG

import chip_smoke
from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

DEVICE_STATE = pytest.mark.parametrize("device_state", [True, False], ids=["device", "host"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(fused_chunk=0, depth=2, tile=0, device_state=True, eos_token_id=None, **over):
    return RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)),
        RaggedConfig(**{**RCFG, "fused_chunk": fused_chunk, "pipeline_depth": depth,
                        "prefill_tile": tile, "device_state": device_state, **over}),
        dtype=torch.float32, params=params_from_numpy(common.np_params()), device="cpu",
        eos_token_id=eos_token_id)


def _prompts(n=5, seed=3):
    """tests/unit/test_ragged_fused.py's prompts: 3 to 11 tokens each."""
    rng = np.random.default_rng(seed)
    return {i: [int(t) for t in rng.integers(0, 97, (int(rng.integers(3, 12)),))]
            for i in range(n)}


def _run(eng, prompts, max_new, **put):
    for uid, p in prompts.items():
        eng.put(uid, p, max_new_tokens=max_new, **put)
    return eng.generate_all()


def _staggered(eng, prompts, max_new, **put):
    """One arrival every other step() while the engine runs."""
    items = list(prompts.items())
    fed = 0
    for step in range(500):
        if fed < len(items) and step % 2 == 0:
            uid, p = items[fed]
            eng.put(uid, p, max_new_tokens=max_new, **put)
            fed += 1
        if eng.has_work:
            eng.step()
        if fed == len(items) and not eng.has_work:
            break
    assert not eng.has_work
    return {uid: list(s.generated) for uid, s in eng._results.items()}


def _leak_free(eng):
    return (eng.allocator.free_blocks == eng.cfg.num_blocks - 1 and eng._reserved == 0
            and len(eng._free_slots) == eng.cfg.max_seqs and not eng._running
            and not eng._pending and not eng._inflight_chunks and not eng.block_tables.any())


@DEVICE_STATE
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_greedy_parity_with_legacy(device_state, depth):
    """The fused pipeline emits exactly the non-fused engine's greedy
    streams, in far fewer dispatches than tokens."""
    prompts = _prompts()
    want = _run(_engine(device_state=device_state), prompts, 9)
    fused = _engine(fused_chunk=4, depth=depth, device_state=device_state)
    got = _run(fused, prompts, 9)
    assert got == want
    emitted = sum(len(v) for v in got.values())
    assert fused.dispatch_count / emitted <= 0.5
    assert _leak_free(fused)


@DEVICE_STATE
def test_parity_with_staggered_arrivals(device_state):
    """Arrivals mid-generation ride step 0 of the fused programs and leave
    every stream as the non-fused engine's."""
    prompts = _prompts(6, seed=11)
    want = _run(_engine(device_state=device_state), prompts, 7)
    fused = _engine(fused_chunk=4, depth=2, device_state=device_state)
    assert _staggered(fused, prompts, 7) == want
    assert _leak_free(fused)


@DEVICE_STATE
def test_eos_truncates_speculation(device_state):
    """An EOS found at readback cuts the stream where the non-fused engine
    stops; the tokens speculated past it are discarded."""
    prompts = _prompts(3, seed=5)
    base = _run(_engine(device_state=device_state), prompts, 10)
    eos = next(int(t) for toks in base.values() for t in toks[:-1])
    want = _run(_engine(device_state=device_state, eos_token_id=eos), prompts, 10)
    fused = _engine(fused_chunk=4, device_state=device_state, eos_token_id=eos)
    got = _run(fused, prompts, 10)
    assert got == want
    assert any(len(v) < 10 for v in got.values())
    assert _leak_free(fused)


@DEVICE_STATE
def test_tiled_prefill_parity(device_state):
    """Fused chunks with tile-aligned prefill give the flat layout's tokens."""
    prompts = _prompts(4, seed=7)
    flat = _run(_engine(fused_chunk=4, device_state=device_state), prompts, 6)
    tiled = _engine(fused_chunk=4, tile=4, device_state=device_state)
    assert _run(tiled, prompts, 6) == flat
    assert _leak_free(tiled)


@DEVICE_STATE
def test_pool_pressure_completes(device_state):
    """More requests than slots and blocks: admission waves drain the queue
    without deadlock and match the non-fused engine."""
    prompts = _prompts(8, seed=13)
    want = _run(_engine(device_state=device_state, num_blocks=25), prompts, 6)
    fused = _engine(fused_chunk=4, device_state=device_state, num_blocks=25)
    assert _run(fused, prompts, 6) == want
    assert _leak_free(fused)


def test_device_vs_host_staged_parity_staggered_eos():
    """Staggered arrivals (slot rows written mid-pipeline) and a mid-stream
    EOS (speculated post-EOS tokens discarded at reconcile): device-resident
    state reproduces the host-staged streams token for token."""
    prompts = _prompts(5, seed=21)
    eos = int(next(iter(_run(_engine(fused_chunk=4, device_state=False), prompts,
                             8).values()))[0])
    got = {ds: _staggered(_engine(fused_chunk=4, device_state=ds, eos_token_id=eos), prompts, 8)
           for ds in (True, False)}
    assert got[True] == got[False]
    assert any(len(v) < 8 for v in got[True].values())


@pytest.mark.parametrize("tile", [0, 4], ids=["flat", "tiled"])
def test_warmup_prepares_the_family_and_leaves_state(tile):
    """warmup() runs each device-resident fused program once on an
    all-scratch staging buffer: it returns the size of the JAX engine's
    family (prefill-only programs at 3 sizes, then 3 scan depths x 4 sizes
    of a step with a decode region: 15 flat or tiled), and changes no slot
    row but the scratch row, no KV but scratch block 0, no table, no
    allocator count and no byte count; the warmed engine then serves the
    host-staged engine's tokens."""
    eng = _engine(fused_chunk=4, tile=tile)
    host = _engine(fused_chunk=4, tile=tile, device_state=False)
    early = _prompts(1, seed=2)[0]
    for e in (eng, host):
        e.put("early", early, max_new_tokens=5)
        e.step()  # live state the scratch runs must not touch
    before = ([t.clone() for t in eng._dev_state], eng.cache["k"].clone(),
              eng.cache["v"].clone(), eng._bt_dev.clone(), eng.block_tables.copy(),
              eng.allocator.free_blocks, eng._reserved, eng.h2d_bytes, eng.stage_bytes,
              eng.dispatch_count, eng.tokens_scheduled, eng.tokens_padded)
    assert eng.warmup() == 15
    nt_prog = (lambda nt: nt) if tile else (lambda nt: 0)
    family = {("fused", t, k, nd, nt_prog(nt), w) for k, nd, nt, w, t in eng._fused_family()}
    assert family <= eng.programs._seen
    state, k, v, bt, bt_host, *counts = before
    for a, b in zip(state, eng._dev_state):
        assert torch.equal(a[:-1], b[:-1])
    assert torch.equal(k[:, 1:], eng.cache["k"][:, 1:])
    assert torch.equal(v[:, 1:], eng.cache["v"][:, 1:])
    assert torch.equal(bt, eng._bt_dev) and (bt_host == eng.block_tables).all()
    assert counts == [eng.allocator.free_blocks, eng._reserved, eng.h2d_bytes,
                      eng.stage_bytes, eng.dispatch_count, eng.tokens_scheduled,
                      eng.tokens_padded]
    assert host.warmup() == 15  # nothing to prepare, the same family
    prompts = _prompts(4, seed=17)
    assert _run(eng, prompts, 6) == _run(host, prompts, 6)
    assert _leak_free(eng)
    assert _engine().warmup() == 0  # no fused chunks, nothing to prepare


def test_config_validation():
    """The reference's rules and messages: fused_chunk is 0 or >= 2, and a
    fused engine needs a window of at least one chunk."""
    with pytest.raises(ValueError, match="fused_chunk must be 0"):
        _engine(fused_chunk=1)
    with pytest.raises(ValueError, match="pipeline_depth must be >= 1"):
        _engine(fused_chunk=2, depth=0)
    _engine(depth=0)  # the window is not read without fused chunks
    with pytest.raises(TypeError):
        RaggedConfig(enable_prefix_cache=True)  # not ported


BENCH_RAGGED = dict(device_state=True, decode_run_ahead=chip_smoke.RUN_AHEAD, fused_chunk=16,
                    pipeline_depth=3)
BENCH_MODEL = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=1,
                   num_heads=4, num_kv_heads=2, max_seq_len=1024)


def test_bench_serving_schedule_matches_jax():
    """The reference bench's serving configuration (``chip_smoke.ENGINE``,
    run-ahead 48, fused chunks of 16, three in flight) over chip_smoke.py's
    32 x 48 workload: with no EOS and greedy picks the schedule does not
    depend on the weights, so a 1-layer tiny model gives the 8B run's. Both
    engines: the same tokens, 12 dispatches of three programs, 9216
    scheduled and 4608 padded tokens (chip_smoke.py's FUSED_SCHEDULE), and
    a warmup family of 29 programs."""
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
                == chip_smoke.FUSED_SCHEDULE), name
    assert got["port"] == got["jax"]
    assert all(len(v) == chip_smoke.MAX_NEW for v in got["port"].values())
    assert sorted(key[1:] for key in peng.programs._seen) == [
        (32, 16, 32, 0, 18), (928, 16, 32, 7, 18), (1024, 1, 0, 8, 18)]
    assert peng.warmup() == chip_smoke.FUSED_WARMUP_PROGRAMS
    assert _leak_free(peng)
