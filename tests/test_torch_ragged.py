"""The port's ragged engine against the JAX package's host-staged engine
(``RaggedConfig(device_state=False)``): same parameters, same requests, fp32
on the CPU, greedy tokens identical; plus the engine's own contracts
(leak-free pool, cancel, deadlines, request validation, device choice).

Sizes, weights, requests and the JAX runs are tests/torch_ragged_common.py's
(the sizes of tests/unit/test_ragged.py).
"""

import dataclasses
import time

import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, MAX_NEW, RCFG

from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy


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


def _requests():
    return common.requests()


def _port_engine(np_params, **over):
    """The port's host-staged engine (the JAX side's ``device_state=False``)."""
    return RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)),
        RaggedConfig(**{**RCFG, "device_state": False, **over}),
        dtype=torch.float32, params=params_from_numpy(np_params), device="cpu")


@pytest.mark.parametrize("prefill_tile", [0, 4], ids=["plain", "tiled"])
def test_greedy_tokens_identical_to_jax(np_params, prefill_tile):
    want, *schedule, _ = common.jax_reference(prefill_tile=prefill_tile, device_state=False)
    peng = _port_engine(np_params, prefill_tile=prefill_tile)
    for uid, prompt in _requests().items():
        peng.put(uid, prompt, max_new_tokens=MAX_NEW)
    got = peng.generate_all()
    assert got == want
    assert all(len(v) == MAX_NEW for v in got.values())
    # same schedule: same dispatches, same padding
    assert [peng.dispatch_count, peng.tokens_scheduled, peng.tokens_padded] == schedule
    # leak-free pool: only scratch block 0 is not free
    assert peng.allocator.free_blocks == RCFG["num_blocks"] - 1
    assert peng._reserved == 0 and not peng.block_tables.any()


def test_cancel_queued_and_running(np_params):
    eng = _port_engine(np_params)
    reqs = _requests()
    for uid in ("r0", "r1", "r2", "r3", "r4"):
        eng.put(uid, reqs[uid], max_new_tokens=MAX_NEW)
    eng.step()  # admits r0..r2 (three slots); r3, r4 wait
    assert eng.get_request("r1").slot >= 0 and eng.get_request("r4").slot == -1
    assert eng.cancel("r1") and eng.cancel("r4")
    assert not eng.cancel("r1")  # already aborting
    assert not eng.cancel("nope")
    out = eng.generate_all()
    assert eng.get_request("r1").status == "cancelled"
    assert eng.get_request("r4").status == "cancelled"
    assert out["r4"] == [] and len(out["r1"]) < MAX_NEW
    for uid in ("r0", "r2", "r3"):
        assert len(out[uid]) == MAX_NEW and eng.get_request(uid).status == "finished"
    assert eng.finished_uids == {"r0", "r1", "r2", "r3", "r4"}
    assert eng.allocator.free_blocks == RCFG["num_blocks"] - 1


def test_deadline_times_out(np_params):
    eng = _port_engine(np_params)
    reqs = _requests()
    eng.put("late", reqs["r2"], max_new_tokens=MAX_NEW, deadline_s=1e-3)
    eng.put("ok", reqs["r3"], max_new_tokens=MAX_NEW)
    time.sleep(0.01)
    out = eng.generate_all()
    assert eng.get_request("late").status == "timeout" and out["late"] == []
    assert len(out["ok"]) == MAX_NEW
    assert eng.allocator.free_blocks == RCFG["num_blocks"] - 1


def test_put_validation(np_params):
    eng = _port_engine(np_params)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.put("a", [])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.put("a", [1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.put("a", [1] * 60, max_new_tokens=5)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.put("a", [1, 2], max_new_tokens=4, deadline_s=0)
    # sampling is accepted (the reference validates none of its controls):
    # an explicit seed is masked to 31 bits, an assigned one mixes the engine
    # seed with the put order
    sampled = _port_engine(np_params)
    sampled.put("s", [1, 2], max_new_tokens=4, temperature=0.7, top_k=5, top_p=0.9,
                seed=-3)
    sampled.put("t", [1, 2], max_new_tokens=4, temperature=0.7)
    assert [(q.temperature, q.top_k, q.top_p, q.seed) for q in sampled._queued] == [
        (0.7, 5, 0.9, -3 & 0x7FFFFFFF), (0.7, 0, 1.0, 1)]
    small = _port_engine(np_params, num_blocks=4)
    with pytest.raises(ValueError, match="KV blocks"):
        small.put("a", [1] * 12, max_new_tokens=4)
    assert not eng.has_work and not small.has_work


def test_default_device_is_the_card(np_params):
    spec = llama.build(llama.LlamaConfig(**CFG))
    rcfg = RaggedConfig(**RCFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RaggedInferenceEngine(spec, rcfg, params=params_from_numpy(np_params))
        return
    eng = RaggedInferenceEngine(spec, rcfg, params=params_from_numpy(np_params))
    assert eng.device == torch.device("cuda", 0)
    assert eng.cache["k"].is_cuda and eng.params["embed"].is_cuda


def test_tiled_config_checks(np_params):
    with pytest.raises(ValueError, match="prefill_tile exceeds"):
        _port_engine(np_params, prefill_tile=32)
    spec = dataclasses.replace(llama.build(llama.LlamaConfig(**CFG)),
                               supports_prefill_tiles=False)
    with pytest.raises(ValueError, match="prefill_tiles"):
        RaggedInferenceEngine(spec, RaggedConfig(**RCFG, prefill_tile=4),
                              params=params_from_numpy(np_params), device="cpu")
