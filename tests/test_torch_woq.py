"""Weight-only quantization in the port (``ops/quantizer.py``, the layer
dequant of ``models/llama.py``, both engines) against the JAX package, on
the CPU.

``quantize`` / ``dequantize`` and ``quantize_params`` give the JAX
package's bytes (values, scales and which leaves stay dense) for 8 and 4
bits; a stacked weight's layer is a view; dequantizing into the compute
dtype gives the bits of dequantizing to fp32 and casting; the weights of
Llama-3-8B come to the bytes ``chip_smoke.py`` gates (built on the meta
device); fp32 greedy and seeded tokens of the ``woq8`` and ``woq4`` ragged
engines and of the WOQ dense engine equal the JAX engines', with
tests/unit/test_kvquant.py's tiny model and the same weights on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import np_params

from deepspeed_tpu.comm.comm import init_distributed
from deepspeed_tpu.comm.topology import reset_topology
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.inference import ragged
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops import quantizer as tq

# tests/unit/test_kvquant.py:44-71's model (torch_ragged_common's sizes), with
# torch_ragged_common's weights: computed once a process, shared with the
# port's other engine tests
CFG = common.CFG
RCFG = dict(max_tokens_per_step=16, max_seqs=3, block_size=4, num_blocks=29,
            max_blocks_per_seq=16)
PROMPTS = {0: [5, 6, 7, 8, 9, 10], 1: [11, 12, 13], 2: [1, 2, 3, 4, 5, 6, 7, 8, 9]}
# Llama-3-8B's weights: bf16, and woq8 / woq4 in blocks of 256 with the
# embedding kept bf16 (the figures chip_smoke.py gates on the card)
BYTES_8B = {0: 16_060_522_496, 8: 8_673_124_352, 4: 4_920_795_136}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _tensor(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(1e-3, 10.0, size=shape)).astype(np.float32)
    x.reshape(-1)[:7] = 0.0
    return x


# ----------------------------------------------------------------- quantizer
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block,shape", [(256, (37,)), (256, (4, 300)), (16, (3, 5, 64))])
def test_quantize_matches_jax(bits, block, shape):
    x = _tensor(shape)
    want = jq.quantize(jnp.asarray(x), bits, block)
    got = tq.quantize(torch.from_numpy(x), bits, block)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.shape == tuple(want.shape)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(tq.dequantize(got, dt).float().numpy(),
                                      np.asarray(jq.dequantize(want, jdt).astype(jnp.float32)))


def test_int8_shifts_wrap_and_keep_the_sign():
    """The int4 packing relies on int8 shifts: the left one wraps, the
    right one is arithmetic."""
    q = torch.tensor([15, -8, 7, -1, 1], dtype=torch.int8)
    assert (q << 4).tolist() == [-16, -128, 112, -16, 16]
    assert ((q << 4) >> 4).tolist() == [-1, -8, 7, -1, 1]
    packed = tq.quantize(torch.tensor([7.0, -7.0, -3.0, 1.0]), bits=4, block=4).values
    assert tq._unpack(packed, 4).tolist() == [[7, -7, -3, 1]]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, prefix + k + ".").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_jax(bits):
    """Values, scales, per-layer shapes and the dense set (embedding,
    norms) equal the JAX package's, bit for bit. Under ``jax.jit`` (as the
    JAX engines run it) XLA turns the divide by qmax into a multiply by its
    reciprocal: the values stay equal and the scales move by at most an ulp
    (``ROADMAP.md`` queue 3)."""
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params())
    want = _flat(jq.quantize_params(jparams, bits))
    jitted = _flat(jax.jit(lambda p: jq.quantize_params(p, bits))(jparams))
    got = _flat(tq.quantize_params(params_from_numpy(np_params()), bits))
    assert set(got) == set(want)
    dense = {k for k, v in got.items() if not isinstance(v, tq.QuantizedWeight)}
    assert dense == {k for k, v in want.items() if not isinstance(v, jq.QuantizedWeight)}
    assert dense == {"embed", "final_norm", "layers.attn_norm", "layers.mlp_norm"}
    for name in set(got) - dense:
        g, w = got[name], want[name]
        assert (g.shape, g.bits, g.block) == (w.shape, w.bits, w.block)
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w.scales))
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(jitted[name].values))
        np.testing.assert_array_max_ulp(g.scales.numpy(), np.asarray(jitted[name].scales), 1)


def test_quantized_weight_layers_are_views():
    src = torch.randn(3, 8, 64, generator=torch.Generator().manual_seed(0))
    w = tq.quantize_params({"layers": {"wq": src}}, 4, block=32)["layers"]["wq"]
    layer = w[1]
    assert layer.values.data_ptr() == w.values[1].data_ptr()
    assert layer.shape == (8, 64) and w.nbytes == 3 * layer.nbytes
    assert torch.equal(tq.maybe_dequantize(layer, torch.float32),
                       tq.dequantize(tq.quantize(src[1], 4, 32)))


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_into_compute_dtype_same_bits(bits):
    """The f32 product rounds once either way, so the layer and head
    dequant go straight to the compute dtype (no fp32 copy of the head)."""
    qt = tq.quantize(torch.from_numpy(_tensor((64, 96), seed=3)), bits)
    for dt in (torch.bfloat16, torch.float16):
        assert torch.equal(tq.dequantize(qt, dt), tq.dequantize(qt, torch.float32).to(dt))


@functools.cache
def meta_8b_params() -> dict:
    """Llama-3-8B's bf16 weights on the meta device: nothing is allocated."""
    return llama.init_params(llama.LlamaConfig.llama3_8b(), None, torch.bfloat16, "meta")


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_llama3_8b_weight_bytes(bits):
    params = meta_8b_params()
    if bits:
        params = tq.quantize_params(params, bits)
    assert tq.params_nbytes(params) == BYTES_8B[bits]


# ------------------------------------------------------------------ engines
def _run(eng, seeded: bool = False) -> dict:
    for i, p in PROMPTS.items():
        eng.put(i, p, max_new_tokens=8)
    if seeded:
        eng.put("seeded", PROMPTS[2], max_new_tokens=8, temperature=0.9, top_k=20, seed=5)
    return eng.generate_all()


# each JAX engine compiles its programs: one seeded run, one fused, one with
# an int8 pool
@pytest.mark.parametrize("quant,mode,seeded", [("woq8", {}, True),
                                               ("woq4", {"fused_chunk": 4}, False),
                                               ("int8+woq4", {"prefill_tile": 8}, False)])
def test_ragged_woq_matches_jax(quant, mode, seeded):
    jcfg = jax_llama.LlamaConfig(**CFG)
    want_eng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx),
        jax_ragged.RaggedConfig(**RCFG, **mode, quant=quant), dtype=jnp.float32,
        params=jax.tree_util.tree_map(jnp.asarray, np_params()))
    want = _run(want_eng, seeded)
    eng = ragged.RaggedInferenceEngine(
        llama.build(llama.LlamaConfig(**CFG)), ragged.RaggedConfig(**RCFG, **mode, quant=quant),
        dtype=torch.float32, params=params_from_numpy(np_params()), device="cpu")
    assert eng.quantize_bits == want_eng.quantize_bits
    assert isinstance(eng.params["layers"]["wq"], tq.QuantizedWeight)
    assert _run(eng, seeded) == want
    assert eng.h2d_bytes == want_eng.h2d_bytes


def test_quantize_bits_arg_equals_woq_component():
    def engine(**kw):
        quant = kw.pop("quant", "off")
        return ragged.RaggedInferenceEngine(
            llama.build(llama.LlamaConfig(**CFG)), ragged.RaggedConfig(**RCFG, quant=quant),
            dtype=torch.float32, params=params_from_numpy(np_params()), device="cpu", **kw)

    a, b = engine(quantize_bits=8), engine(quant="woq8")
    assert a.quantize_bits == b.quantize_bits == 8
    assert _run(a) == _run(b)


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX dense engines, woq8 and woq4, on a one-device mesh."""
    reset_topology()
    init_distributed(MeshConfig(data=1), devices=jax.devices()[:1])
    cfg = jax_llama.LlamaConfig(**CFG)
    engines = {bits: JaxInferenceEngine(lambda ctx: jax_llama.build(cfg, ctx=ctx),
                                        params=jax.tree_util.tree_map(jnp.asarray, np_params()),
                                        dtype=jnp.float32, quantize_bits=bits)
               for bits in (8, 4)}
    yield engines
    reset_topology()


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_woq_matches_jax(jax_dense, bits):
    prompt = np.random.default_rng(2).integers(0, CFG["vocab_size"], (2, 6)).astype(np.int32)
    eng = InferenceEngine(llama.build(llama.LlamaConfig(**CFG)), dtype=torch.float32,
                          params=params_from_numpy(np_params()), quant=f"woq{bits}",
                          device="cpu")
    assert eng.quantize_bits == bits
    for kw in ({}, dict(temperature=0.8, seed=3, top_k=9)):
        np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=6, **kw),
                                      jax_dense[bits].generate(prompt, max_new_tokens=6, **kw))
    np.testing.assert_allclose(eng.forward(prompt).numpy(),
                               np.asarray(jax_dense[bits].forward(prompt)), rtol=0, atol=1e-4)
