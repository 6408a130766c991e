"""KV handoff and prefix transfer in the port's ragged engine against the
JAX engine, on the CPU with tests/torch_ragged_common.py's tiny model and
weights. An fp32 ``KVHandoff`` the JAX engine exports and serializes with its
``to_bytes`` resumes in the port (``from_bytes``, ``import_handoff``) to the
JAX engine's cold tokens, and a record the port exports resumes in the JAX
engine to them too, greedy and seeded, in the host-staged, device run-ahead,
fused and scheduler + speculation modes, with the blocks exported equal to
the blocks imported; a damaged record raises; a bf16 record reads back bit
for bit and resumes to a single bf16 engine's tokens; ``export_prefix`` /
``import_prefix`` seed an engine that never saw the prompt.
"""

import numpy as np
import pytest
import torch
import torch_prefix_common as pc
from torch_prefix_common import BS, MODES, PROMPT_A, PROMPT_B, SAMPLED

from deepspeed_tpu_torch.inference.ragged import KVHandoff


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", list(MODES))
def test_handoff_crosses_packages(mode):
    jax_run = pc.jax_drive(mode)
    want = pc.jax_cold()
    # JAX -> port: the JAX engine's records, made after a prefix hit
    eng = pc.port_engine(MODES[mode])
    for buf in jax_run["records"].values():
        rec = KVHandoff.from_bytes(buf)
        assert rec.n_blocks * BS >= len(PROMPT_B) and len(rec.generated) == 1
        assert rec.block_payload["k"].dtype == torch.float32
        assert eng.import_handoff(rec)
    out = eng.generate_all()
    assert {"g": out["hg"], "s": out["hs"]} == want
    assert eng.kv_blocks_imported == jax_run["exported"]
    # port -> JAX
    _, port_exported = pc.port_records(mode)
    assert {"g": jax_run["resumed"]["pg"], "s": jax_run["resumed"]["ps"]} == want
    assert jax_run["imported"] == port_exported
    assert eng.allocator.free_blocks == eng.cfg.num_blocks - 1


@pytest.mark.parametrize("damage", ["flip", "truncate", "trailing", "magic"])
def test_handoff_bytes_reject_damage(damage):
    buf = bytearray(pc.port_records("host")[0]["pg"])
    if damage == "flip":
        buf[len(buf) // 2] ^= 0x01
    elif damage == "truncate":
        buf = buf[:-7]
    elif damage == "trailing":
        buf += b"\0"
    else:
        buf[0] ^= 0x01
    with pytest.raises(ValueError):
        KVHandoff.from_bytes(bytes(buf))


def test_bf16_record_round_trips_bit_for_bit():
    """numpy has no bfloat16: a bf16 record keeps its payload as tensors and
    reads back bit for bit, and resumes to a single bf16 engine's tokens."""
    params = {k: v for k, v in pc.port_engine({}).params.items()}

    def engine(over):
        eng = pc.port_engine(over, params=params)
        return pc.ragged.RaggedInferenceEngine(
            eng.spec, eng.cfg, dtype=torch.bfloat16, params=params, device="cpu")

    single = engine(MODES["fused"])
    single.put("s", PROMPT_B, max_new_tokens=pc.MAX_NEW, **SAMPLED)
    want = single.generate_all()["s"]
    pre = engine({})
    pre.put("s", PROMPT_B, max_new_tokens=pc.MAX_NEW, handoff=True, **SAMPLED)
    pre.generate_all()
    rec = pre.export_handoff("s")
    back = KVHandoff.from_bytes(rec.to_bytes())
    for name in ("k", "v"):
        a, b = rec.block_payload[name], back.block_payload[name]
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert np.array_equal(back.row_iv, rec.row_iv) and back.nbytes == rec.nbytes
    dec = engine(MODES["fused"])
    assert dec.import_handoff(back)
    assert dec.generate_all()["s"] == want
    assert pre.export_handoff("s") is None  # exported once


def test_prefix_transfer_into_engine_that_never_saw_prompt():
    src = pc.port_engine(dict(enable_prefix_cache=True))
    src.put("warm", PROMPT_A, max_new_tokens=4)
    src.generate_all()
    payload = src.export_prefix(PROMPT_B)
    assert payload.tokens == PROMPT_B[:2 * BS] and payload.n_blocks == 2
    dst = pc.port_engine(dict(enable_prefix_cache=True, **MODES["fused"]))
    assert dst.cached_prefix_len(PROMPT_B) == 0
    assert dst.import_prefix(payload) == 2 * BS
    assert dst.import_prefix(payload) == 2 * BS  # already published: kept
    assert dst.kv_blocks_imported == src.kv_blocks_exported == 2
    pc.put_pair(dst)
    out = dst.generate_all()
    assert dst.prefix_hits == 2
    assert {"g": out["g"], "s": out["s"]} == pc.jax_cold()


def test_discard_and_cancelled_handoff_free_their_blocks():
    eng = pc.port_engine(dict(enable_prefix_cache=True))
    eng.put("h", PROMPT_B, max_new_tokens=pc.MAX_NEW, handoff=True)
    eng.put("c", PROMPT_A, max_new_tokens=pc.MAX_NEW, handoff=True)
    eng.step()
    eng.cancel("c")  # a cancelled handoff is freed, never parked
    eng.generate_all()
    assert set(eng._handoffs) == {"h"} and len(eng.generate_all()["h"]) == 1
    assert eng.discard_handoff("h") and not eng.discard_handoff("h")
    assert eng.allocator.free_blocks == eng.cfg.num_blocks - 1
    assert eng.cached_prefix_len(PROMPT_B) == 2 * BS  # published on discard
