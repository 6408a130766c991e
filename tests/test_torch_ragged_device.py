"""The port's device-resident serving path, decode run-ahead and fused mixed
chunks against the JAX engine, on the CPU: fp32, the tiny Llama and
``RaggedConfig`` of tests/test_torch_ragged.py, the same weights on both
sides (``models/convert.params_from_numpy``), greedy tokens identical, in
the plain, tiled, run-ahead and fused (flat and tiled) modes with
``device_state`` True and False on each side
(tests/unit/test_ragged.py:91,122,305-310,327). Then the device path's
own contracts, each a port of one test of
tests/unit/test_ragged.py's ``TestDeviceResidentState``: steady decode
stages nothing, readback runs one dispatch behind, cancel and deadlines in
flight free every block and slot, a reused slot's rows are rewritten, and
run-ahead stops at EOS and the budget. Every comparison is exact.

On the CPU the program cache runs every program eagerly
(``inference/cuda_graphs.py``), so these tests drive all of the scheduling
logic; the graphs themselves are held in tests/test_torch_cuda.py.
"""

import time

import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, MAX_NEW, RCFG

from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

# tests/unit/test_ragged.py's DISPATCH_MODES, and the fused mode with tiled
# prefill
MODES = {"plain": {}, "tiled": {"prefill_tile": 8}, "run_ahead": {"decode_run_ahead": 4},
         "fused": {"fused_chunk": 4, "pipeline_depth": 2},
         "fused_tiled": {"fused_chunk": 4, "pipeline_depth": 2, "prefill_tile": 8}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: under pytest-xdist every
    worker would otherwise start as many as the host has cores, and the
    engines' many small ops spend most of their time contending for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return common.np_params()


_requests = common.requests


def _engine(np_params, device_state=True, eos_token_id=None, **over):
    return RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)),
        RaggedConfig(**{**RCFG, "device_state": device_state, **over}),
        dtype=torch.float32, params=params_from_numpy(np_params), device="cpu",
        eos_token_id=eos_token_id)


def _run(eng, requests, max_new=MAX_NEW, **put):
    for uid, prompt in requests.items():
        eng.put(uid, prompt, max_new_tokens=max_new, **put)
    return eng.generate_all()


def _leak_free(eng):
    return (eng.allocator.free_blocks == eng.cfg.num_blocks - 1 and eng._reserved == 0
            and len(eng._free_slots) == eng.cfg.max_seqs and not eng._running
            and not eng._pending and not eng._inflight_chunks and not eng.block_tables.any())


@pytest.mark.parametrize("device_state", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_identical_to_jax(np_params, mode, device_state):
    """Same tokens, same schedule (dispatches, scheduled and padded tokens);
    with device state also the same H2D bytes, which the port accounts as
    the JAX engine does."""
    want, *schedule, h2d = common.jax_reference(**MODES[mode], device_state=device_state)
    peng = _engine(np_params, device_state, **MODES[mode])
    got = _run(peng, _requests())
    assert got == want
    assert all(len(v) == MAX_NEW for v in got.values())
    assert [peng.dispatch_count, peng.tokens_scheduled, peng.tokens_padded] == schedule
    if device_state:
        assert peng.h2d_bytes == h2d
        kinds = {key[0] for key in peng.programs._seen}
        assert ("chunk" in kinds) == (mode == "run_ahead")
        assert kinds == {"fused"} if mode.startswith("fused") else "fused" not in kinds
    assert _leak_free(peng)


def test_steady_decode_stages_zero_bytes(np_params):
    """Once every sequence decodes, the packed staging buffer byte-compares
    equal step to step and no table row is dirty: further steps upload
    nothing. Block size 16: the request (11 prompt + 5 new tokens) fits one
    block, so no table growth dirties a row mid-decode."""
    eng = _engine(np_params, block_size=16, num_blocks=13, max_blocks_per_seq=8)
    eng.put("a", _requests(23, (11,))["r0"], max_new_tokens=5)
    eng.step()  # prefill dispatch
    eng.step()  # first decode dispatch: its staging buffer is uploaded here
    assert all(s.in_decode for s in eng._running.values())
    h2d0 = eng.h2d_bytes
    for _ in range(2):
        eng.step()
    assert eng.h2d_bytes == h2d0, "steady-state decode still staging host bytes"
    assert eng.steady_dispatches == 2 and eng.steady_h2d_bytes == 0
    eng.generate_all()
    assert _leak_free(eng)


def test_readback_is_double_buffered(np_params):
    """A dispatch's tokens are reconciled one step later (a window of one
    pending dispatch), and drain() flushes the window."""
    eng = _engine(np_params)
    eng.put("a", _requests(lens=(5,))["r0"], max_new_tokens=6)
    assert eng.step() == {}  # prefill dispatched, nothing reconciled yet
    assert len(eng._pending) == 1
    assert eng.get_request("a").generated == []
    drained = eng.drain()
    assert not eng._pending and list(drained) == ["a"]
    assert len(eng.get_request("a").generated) == 1
    out = eng.generate_all()
    assert len(out["a"]) == 6
    assert _leak_free(eng)


@pytest.mark.parametrize("mode", list(MODES))
def test_cancel_mid_flight_with_pending_dispatch(np_params, mode):
    """cancel() while a dispatch that references the sequence is in flight:
    it retires through the deferred release, its blocks and slot are
    recycled, and the other request's tokens are those of a run without
    it. Both prompts complete in the first dispatch, so it references both
    (fused: the second chunk of the first window, still in flight)."""
    want = None
    for with_cancel in (False, True):
        eng = _engine(np_params, **MODES[mode])
        reqs = _requests(29, (5, 3))
        eng.put("keep", reqs["r0"], max_new_tokens=8)
        if with_cancel:
            eng.put("dead", reqs["r1"], max_new_tokens=8)
        eng.step()  # a dispatch in flight referencing both
        if with_cancel:
            assert (eng._pending or eng._inflight_chunks) and eng.get_request("dead").refs == 1
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


def test_deadline_timeout_mid_flight(np_params):
    eng = _engine(np_params)
    eng.put("t", _requests(lens=(23,))["r0"], max_new_tokens=40, deadline_s=0.05)
    eng.step()
    assert eng._pending
    time.sleep(0.08)
    eng.generate_all()
    assert eng.get_request("t").status == "timeout"
    assert len(eng.get_request("t").generated) < 40
    assert _leak_free(eng)


@pytest.mark.parametrize("mode", list(MODES))
def test_slot_reuse_rewrites_device_rows(np_params, mode):
    """Six requests through three slots: each admission writes its slot's
    seven rows anew (last token 0, position 0, the request's seed, prompt
    length, temperature 0, top-k 0, top-p 1) over what the previous
    occupant left, so each request's tokens equal the host-staged
    engine's. The engine assigns seed i to the i-th put (engine seed 0)."""
    reqs = {f"{wave}-{uid}": p for wave in (0, 1)
            for uid, p in _requests(wave, (5, 11, 23)).items()}
    dev = _engine(np_params, **MODES[mode])
    host = _engine(np_params, device_state=False, **MODES[mode])
    writes = []
    write = dev._write_slot_row

    def spy(seq):
        before = int(dev._dev_state[1][seq.slot])
        write(seq)
        writes.append((before, [float(st[seq.slot]) for st in dev._dev_state],
                       len(seq.prompt), seq.seed))

    dev._write_slot_row = spy
    got = _run(dev, reqs, max_new=5)
    assert got == _run(host, reqs, max_new=5)
    assert len(writes) == len(reqs)
    assert sorted(seed for *_, seed in writes) == list(range(len(reqs)))
    for _, row, plen, seed in writes:
        assert row == [0.0, 0.0, float(seed), float(plen), 0.0, 0.0, 1.0]
    assert sum(before > 0 for before, *_ in writes) == 3  # the reused slots
    assert _leak_free(dev)


@pytest.mark.parametrize("device_state", [True, False], ids=["device", "host"])
def test_run_ahead_respects_eos_and_limits(np_params, device_state):
    """EOS inside a run-ahead chunk truncates the stream exactly as the
    per-step engine does, and no stream passes max_new_tokens."""
    reqs = _requests(5)
    base = _run(_engine(np_params, device_state), reqs)
    eos = next(t for toks in base.values() for t in toks[1:-1])
    want = _run(_engine(np_params, device_state, eos_token_id=eos), reqs)
    ahead = _engine(np_params, device_state, decode_run_ahead=5, eos_token_id=eos)
    got = _run(ahead, reqs)
    assert got == want
    assert any(len(v) < MAX_NEW for v in got.values())
    for toks in got.values():
        assert len(toks) <= MAX_NEW
        if eos in toks:
            assert toks.index(eos) == len(toks) - 1
    assert _leak_free(ahead)
