"""Low-bit KV serving in the port (``inference/kvquant.py``, the quantized
pool through ``models/paged.py``, ``ops/attention.py`` and
``inference/ragged.py``) against the JAX package, on the CPU, with
tests/unit/test_kvquant.py's tiny model (2 layers, hidden 32, 4-token
blocks) and the same weights on both sides.

- the codec: ``quantize_kv_rows`` bit for bit the JAX package's, int8 and
  fp8 (compared as bytes), zero rows and rows whose scale rounds to 0
  included; the config grammar; the pool's shapes, dtypes and bytes;
- the engine: fp32 greedy and seeded tokens, schedule and H2D bytes of the
  ``quant="int8"`` engine equal the JAX engine's in the four modes of
  test_kvquant.py, ``"fp8"`` in one, with the pools' payloads within one
  quantization step (K/V in fp32 may differ by an ulp between frameworks)
  and ``kv_quant_stats`` equal;
- the records: prefix hits and tier restores (host and disk) of int8
  blocks reproduce the cold int8 tokens in every dispatch mode, and so do
  handoff imports; a JAX int8 handoff record resumes in the port and the
  port's in the JAX engine; a record under another codec raises (handoff,
  disk) or misses (prefix); an fp8 record reads back bit for bit.
"""

import functools
import pickle
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_prefix_common as pc
import torch_ragged_common as common
from torch_ragged_common import np_params

from deepspeed_tpu.inference import kvquant as jax_kvq
from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference import kvquant, ragged
from deepspeed_tpu_torch.inference.kvtier import DiskTier, KVCodecMismatch
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

# tests/unit/test_kvquant.py:44-71's model (torch_ragged_common's sizes), with
# torch_ragged_common's weights: computed once a process, shared with the
# port's other engine tests
CFG = common.CFG
RCFG = dict(max_tokens_per_step=16, max_seqs=3, block_size=4, num_blocks=29,
            max_blocks_per_seq=16)
MODES = {"plain": {}, "tiled": {"prefill_tile": 8}, "run_ahead": {"decode_run_ahead": 4},
         "fused": {"fused_chunk": 4, "pipeline_depth": 2}}
PROMPTS = {0: [5, 6, 7, 8, 9, 10], 1: [11, 12, 13], 2: [1, 2, 3, 4, 5, 6, 7, 8, 9]}
SEEDED = dict(temperature=0.9, top_k=20, seed=123)
HANDOFF_PROMPT = [4, 8, 15, 16, 23, 42, 7]
MAX_NEW = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def port_engine(quant, **over):
    return ragged.RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)),
        ragged.RaggedConfig(**{**RCFG, **over, "quant": quant}), dtype=torch.float32,
        params=params_from_numpy(np_params()), device="cpu")


def jax_engine(quant, **over):
    jcfg = jax_llama.LlamaConfig(**CFG)
    return jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx),
        jax_ragged.RaggedConfig(**{**RCFG, **over, "quant": quant}), dtype=jnp.float32,
        params=jax.tree_util.tree_map(jnp.asarray, np_params()))


# the mode whose workload is full; the JAX engine compiles each program
# shape, so the others run PROMPTS alone
FULL_MODE = "plain"


def workload(eng, full: bool) -> dict:
    """PROMPTS greedy; ``full``: also a seeded request, a cold request on
    HANDOFF_PROMPT ("cold") and a prefill-stage one ("h", handoff=True)."""
    for i, p in PROMPTS.items():
        eng.put(i, p, max_new_tokens=MAX_NEW)
    if full:
        eng.put("seeded", PROMPTS[2], max_new_tokens=MAX_NEW, **SEEDED)
        eng.put("cold", HANDOFF_PROMPT, max_new_tokens=MAX_NEW)
        eng.put("h", HANDOFF_PROMPT, max_new_tokens=MAX_NEW, handoff=True)
    return eng.generate_all()


def snapshot(eng) -> dict:
    return dict(dispatch_count=eng.dispatch_count, tokens_scheduled=eng.tokens_scheduled,
                tokens_padded=eng.tokens_padded, h2d_bytes=eng.h2d_bytes)


def to_jax_record(buf: bytes):
    """A port record as the JAX engine takes it: its ``QuantizedKV`` leaves
    (CPU tensors after unpickling) rebuilt as the JAX package's."""
    rec = jax_ragged.KVHandoff.from_bytes(buf)

    def q_of(v):
        if v.codec == "fp8":
            return v.q.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
        return v.q.numpy()

    rec.block_payload = {k: jax_kvq.QuantizedKV(jnp.asarray(q_of(v)), jnp.asarray(v.s.numpy()),
                                                v.codec, v._dtype_name)
                         for k, v in rec.block_payload.items()}
    return rec


@functools.cache
def port_run(quant: str, mode: str, full: bool) -> dict:
    eng = port_engine(quant, **MODES[mode])
    out = workload(eng, full)
    return dict(tokens=out, snap=snapshot(eng), stats=eng.kv_quant_stats(),
                pool={k: (eng.cache[k].q.clone(), eng.cache[k].s.clone()) for k in ("k", "v")},
                record=eng.export_handoff("h").to_bytes() if full else None)


def jax_run(quant: str, mode: str) -> dict:
    """The JAX engine's run of ``workload`` (full in FULL_MODE: then also
    its handoff record and, on the same engine, the tokens it resumes from
    the port's record), once a test run (``torch_ragged_common.shared``)."""
    return common.shared(_jax_run, quant, mode)


def _jax_run(quant: str, mode: str) -> dict:
    full = mode == FULL_MODE
    eng = jax_engine(quant, **MODES[mode])
    out = workload(eng, full)
    res = dict(tokens=out, snap=snapshot(eng), stats=eng.kv_quant_stats(),
               pool={k: (np.array(eng.cache[k].q), np.array(eng.cache[k].s))
                     for k in ("k", "v")})
    if full:
        res["record"] = eng.export_handoff("h").to_bytes()
        assert eng.import_handoff(to_jax_record(port_run(quant, mode, True)["record"]))
        res["resumed"] = eng.generate_all()["h"]
    return res


# ------------------------------------------------------------------ codec
def _rows():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 2, 16)) * rng.uniform(1e-3, 30, size=(64, 2, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0                                    # a zero row: scale 1, payload 0
    x[1, 0] = 0.0
    x[1, 0, :6] = [1e-9, 0, -1e-9, 0, 3e-7, 1e-12]  # scale rounds to 0 in fp16
    x[2, 1] = 0.0
    x[2, 1, :3] = [5e-6, -5e-6, 1e-6]             # int8: a subnormal scale; fp8: 0
    x[3, 0] = 1e-5
    x[4, 1] = 448.0 * 3
    return x


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_codec_bits_match_jax(codec):
    x = _rows()
    qj, sj = jax_kvq.quantize_kv_rows(jnp.asarray(x), jax_kvq.get_codec(codec))
    qt, st = kvquant.quantize_kv_rows(torch.from_numpy(x), kvquant.get_codec(codec))
    assert qt.dtype == kvquant.get_codec(codec).storage and st.dtype == torch.float16
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(), np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.view(torch.int16).numpy(), np.asarray(sj).view(np.int16))
    np.testing.assert_array_equal(kvquant.dequantize_kv_rows(qt, st).numpy(),
                                  np.asarray(jax_kvq.dequantize_kv_rows(qj, sj)))
    # what a row whose scale rounds to 0 stores: int8 0 for 0 / 0 and
    # +-127 for the rest, fp8 the negative NaN (0xFF) for 0 / 0
    assert float(st[1, 0]) == 0.0
    want = [127, 0, -127, 0, 127, 127] if codec == "int8" else [0x7E, 0xFF, 0xFE, 0xFF, 0x7E, 0x7E]
    got = qt[1, 0, :6] if codec == "int8" else qt[1, 0, :6].view(torch.uint8)
    assert got.tolist() == want


def test_fp8_payload_is_ml_dtypes_e4m3fn():
    x = _rows()[5:20]
    qt, st = kvquant.quantize_kv_rows(torch.from_numpy(x), kvquant.get_codec("fp8"))
    y = np.clip(x / st.float().numpy()[..., None], -448, 448)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  y.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


@pytest.mark.parametrize("spec", [None, "off", "", "int8", "fp8", "woq8", "woq4", "qcol",
                                  "int8+woq8+qcol", " FP8 + woq4 ", "int8+fp8", "woq8+woq4",
                                  "int8+turbo", "int4", 8])
def test_parse_quant_matches_jax(spec):
    try:
        want = jax_kvq.parse_quant(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            kvquant.parse_quant(spec)
        assert str(got.value) == str(e)
        return
    got = kvquant.parse_quant(spec)
    assert (got.kv and got.kv.name, got.woq_bits, got.qcol) == \
        (want.kv and want.kv.name, want.woq_bits, want.qcol)


def test_drift_gauges_match_jax():
    want = {0: [1, 2, 3, 4], 1: [5, 6]}
    got = {0: [1, 2, 9, 4], 1: [5, 6]}
    assert kvquant.token_match_rate(want, got) == jax_kvq.token_match_rate(want, got)
    for drift in (None, 0.01, 0.5):
        assert kvquant.drift_verdict(0.96, drift) == jax_kvq.drift_verdict(0.96, drift)
    assert kvquant.DRIFT_BUDGET == jax_kvq.DRIFT_BUDGET


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_pool_matches_jax(codec):
    """Shapes, storage and compute dtypes, bytes, bytes a token and a block,
    and no fp pool: ``init_paged_cache`` runs on the meta device only."""
    port = port_engine(codec)
    jeng = jax_engine(codec)
    for name in ("k", "v"):
        p, j = port.cache[name], jeng.cache[name]
        assert isinstance(p, kvquant.QuantizedKV) and p.codec == j.codec == codec
        assert tuple(p.shape) == tuple(j.shape) and tuple(p.s.shape) == tuple(j.s.shape)
        assert str(p.q.dtype).replace("torch.", "") == str(np.dtype(j.q.dtype))
        assert p.s.dtype == torch.float16 and p.dtype == torch.float32
        assert p.nbytes == j.nbytes
    assert set(port.cache) == {"k", "v"}
    assert port.kv_bytes_per_token() == jeng.kv_bytes_per_token()
    assert port._block_bytes() == jeng._block_bytes()
    fn = llama.build(llama.LlamaConfig(**CFG)).init_paged_cache_fn
    jfn = jax_llama.build(jax_llama.LlamaConfig(**CFG)).init_paged_cache_fn
    for dt, jdt in ((torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16)):
        assert kvquant.paged_block_bytes(fn, 29, 4, dt) == jax_kvq.paged_block_bytes(jfn, 29, 4,
                                                                                      jdt)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("mode", list(MODES))
def test_int8_engine_matches_jax(mode):
    """Greedy and seeded tokens, schedule, H2D bytes and ``kv_quant_stats``
    equal the JAX engine's; the pools within one quantization step."""
    got, want = port_run("int8", mode, mode == FULL_MODE), jax_run("int8", mode)
    assert got["tokens"] == want["tokens"]
    assert got["snap"] == want["snap"]
    assert got["stats"] == want["stats"]
    for name in ("k", "v"):
        # block 0 is the scratch block padding rows write into (the JAX
        # run-ahead chunk's pad rows run on in it, the port's stay at 0)
        (q, s), (jq, js) = got["pool"][name], want["pool"][name]
        assert int((q[:, 1:].int() - torch.from_numpy(jq[:, 1:]).int()).abs().max()) <= 1
        np.testing.assert_allclose(s[:, 1:].float().numpy(), js[:, 1:].astype(np.float32),
                                   rtol=2e-3, atol=0)


def test_fp8_engine_matches_jax():
    """Tokens, schedule and stats; the port's fp8 record (its payload as
    e4m3fn bytes) resumes in the JAX engine, and the JAX engine's in the
    port, to the cold tokens."""
    got, want = port_run("fp8", FULL_MODE, True), jax_run("fp8", FULL_MODE)
    assert got["tokens"] == want["tokens"] and got["snap"] == want["snap"]
    assert got["stats"] == want["stats"]
    cold = want["tokens"]["cold"]
    assert want["resumed"] == cold
    eng = port_engine("fp8")
    assert eng.import_handoff(ragged.KVHandoff.from_bytes(want["record"]))
    assert eng.generate_all()["h"] == cold


def test_quantized_forward_counts_the_plain_path():
    """A quantized pool's attention is the quantized plain path, by the
    pool's type; the fp pool's plain version is not called."""
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa

    pa.reset_counts()
    eng = port_engine("int8", prefill_tile=8)
    eng.put(0, PROMPTS[2], max_new_tokens=3)
    eng.generate_all()
    assert pa.quantized_decode_attention.calls > 0 and pa.quantized_prefill_attention.calls > 0
    assert pa.paged_decode_attention_ref.calls == pa.ragged_prefill_attention_ref.calls == 0
    pa.reset_counts()


# --------------------------------------------------------------- records
def test_handoff_records_cross_packages():
    """A JAX int8 record (its ``QuantizedKV`` mapped to the port's without
    the JAX package) resumes in the port to the cold tokens, and the port's
    record resumes in the JAX engine to them."""
    want = jax_run("int8", FULL_MODE)
    cold = want["tokens"]["cold"]
    assert port_run("int8", FULL_MODE, True)["tokens"]["cold"] == cold
    rec = ragged.KVHandoff.from_bytes(want["record"])
    assert rec.codec == "int8" and isinstance(rec.block_payload["k"], kvquant.QuantizedKV)
    assert rec.block_payload["k"].q.dtype == torch.int8
    eng = port_engine("int8")
    assert eng.import_handoff(rec)
    assert eng.generate_all()["h"] == cold
    assert want["resumed"] == cold


def test_record_unpickler_refuses_other_jax_globals():
    body = pickle.dumps({"x": jax_ragged.RaggedConfig()}, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        kvquant.load_record(body)


@functools.cache
def cold_int8() -> dict:
    eng = pc.port_engine({"quant": "int8"})
    pc.put_pair(eng)
    return eng.generate_all()


def tier_drive(mode: str, quant: str):
    """tests/torch_prefix_common.py's workload: ([(tokens, snapshot)],
    tier stats, block bytes)."""
    with tempfile.TemporaryDirectory() as d:
        eng = pc.port_engine({**pc.MODES[mode], **pc.TIER, "kv_tier_dir": d, "quant": quant})
        try:
            return pc.drive(eng), eng.kv_tier_stats(), eng._block_bytes()
        finally:
            eng._kvtier.close()


@pytest.mark.parametrize("mode", list(pc.MODES))
def test_prefix_hits_and_tier_restores_reproduce_cold(mode):
    """tests/torch_prefix_common.py's workload on an int8 pool: the hits,
    and the hits after the churn demoted the blocks down both tiers and
    promoted them back, reproduce the cold int8 tokens; the tiers move the
    blocks the fp pool's run moves, at the quantized block's bytes."""
    phases, stats, block_bytes = tier_drive(mode, "int8")
    _, fp_stats, fp_block_bytes = tier_drive(mode, "off")
    cold = cold_int8()
    assert {u: phases[0][0][u] for u in ("g", "s")} == {"g": cold["g"], "s": cold["s"]}
    assert {"g": phases[1][0]["g2"], "s": phases[1][0]["s2"]} == {"g": cold["g"],
                                                                  "s": cold["s"]}
    assert phases[0][1]["prefix_hits"] > 0 and phases[1][1]["prefix_hits"] > 0
    counts = ("demotions", "spills", "promotions_host", "promotions_disk", "host_blocks",
              "disk_blocks")
    assert {k: stats[k] for k in counts} == {k: fp_stats[k] for k in counts}
    assert stats["codec"] == "int8" and stats["promotions_disk"] > 0
    assert stats["host_bytes"] == stats["host_blocks"] * block_bytes
    assert block_bytes < fp_block_bytes and stats["disk_bytes"] < fp_stats["disk_bytes"]


@pytest.mark.parametrize("mode", list(pc.MODES))
def test_int8_handoff_reproduces_cold(mode):
    pre = pc.port_engine({"quant": "int8"})
    records = pc.handoff_prefill(pre, ("g", "s"))
    dec = pc.port_engine({**pc.MODES[mode], "quant": "int8"})
    for buf in records.values():
        rec = ragged.KVHandoff.from_bytes(buf)
        assert rec.codec == "int8" and rec.nbytes == sum(
            a.nbytes for a in (rec.block_payload["k"], rec.block_payload["v"],
                               rec.row_iv, rec.row_fv))
        assert dec.import_handoff(rec)
    out = dec.generate_all()
    cold = cold_int8()
    assert {"g": out["g"], "s": out["s"]} == {"g": cold["g"], "s": cold["s"]}
    assert dec.allocator.free_blocks == dec.cfg.num_blocks - 1


def test_codec_mismatch_raises_or_misses():
    """A handoff under another codec raises, a disk record under another
    codec raises ``KVCodecMismatch``, a prefix payload under another codec
    is a miss."""
    buf = port_run("int8", FULL_MODE, True)["record"]
    with pytest.raises(ValueError, match="does not match"):
        port_engine("off").import_handoff(ragged.KVHandoff.from_bytes(buf))
    with pytest.raises(ValueError, match="does not match"):
        port_engine("fp8").import_handoff(ragged.KVHandoff.from_bytes(buf))
    src = port_engine("int8", enable_prefix_cache=True)
    src.put(0, pc.PROMPT_A, max_new_tokens=2)
    src.generate_all()
    payload = src.export_prefix(pc.PROMPT_A)
    assert payload.codec == "int8" and payload.n_blocks == 2
    assert port_engine("fp8", enable_prefix_cache=True).import_prefix(payload) == 0
    assert port_engine("int8", enable_prefix_cache=True).import_prefix(payload) == 8
    with tempfile.TemporaryDirectory() as d:
        assert DiskTier(d, 4, codec="int8").put(("key",), src._gather_blocks([1]))
        assert isinstance(DiskTier(d, 4, codec="int8").get(("key",))["k"], kvquant.QuantizedKV)
        with pytest.raises(KVCodecMismatch):
            DiskTier(d, 4, codec="off").get(("key",))


def test_fp8_record_round_trips_bit_for_bit():
    """numpy has no float8 and torch's pickle does not read a float8 tensor
    back: the record carries the payload's bytes as uint8."""
    rec = ragged.KVHandoff.from_bytes(port_run("fp8", FULL_MODE, True)["record"])
    back = ragged.KVHandoff.from_bytes(rec.to_bytes())
    for name in ("k", "v"):
        a, b = rec.block_payload[name], back.block_payload[name]
        assert b.q.dtype == torch.float8_e4m3fn and b.s.dtype == torch.float16
        assert torch.equal(a.q.view(torch.uint8), b.q.view(torch.uint8))
        assert torch.equal(a.s, b.s)
    dec = port_engine("fp8")
    assert dec.import_handoff(back)
    assert dec.generate_all()["h"] == port_run("fp8", FULL_MODE, True)["tokens"]["cold"]
