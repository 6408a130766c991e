"""The port's dense-cache engine (``deepspeed_tpu_torch/inference/engine.py``,
``models/llama.py decode_forward``) against the JAX package on the CPU, in
fp32 on ``LlamaConfig.tiny()`` with the same weights on both sides.

``decode_forward`` logits (a prefill, then decode steps) within 1e-4 of
JAX's; ``InferenceEngine.generate`` tokens identical to the JAX engine's,
greedy and seeded with temperature, top-k, top-p and the repetition
penalty; ``init_inference``'s refusals of what is not ported yet, each
naming its ``ROADMAP.md`` item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.comm import init_distributed
from deepspeed_tpu.comm.topology import reset_topology
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.engine import InferenceEngine, init_inference
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4
VOCAB = 256
B, T, N = 3, 6, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    p = jax_llama.init_params(jax_llama.LlamaConfig.tiny(VOCAB), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.array, p)


@pytest.fixture(scope="module")
def jax_engine(np_params):
    """The JAX engine on a one-device mesh (the port runs on one device)."""
    reset_topology()
    init_distributed(MeshConfig(data=1), devices=jax.devices()[:1])
    cfg = jax_llama.LlamaConfig.tiny(VOCAB)
    eng = JaxInferenceEngine(lambda ctx: jax_llama.build(cfg, ctx=ctx),
                             params=jax.tree_util.tree_map(jnp.asarray, np_params),
                             dtype=jnp.float32)
    yield eng
    reset_topology()


def _engine(np_params):
    return InferenceEngine(llama.build(llama.LlamaConfig.tiny(VOCAB)), dtype=torch.float32,
                           params=params_from_numpy(np_params), device="cpu")


def _prompt(seed=2, b=B, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


def test_decode_forward_matches_jax(np_params):
    cfg_j, cfg_t = jax_llama.LlamaConfig.tiny(VOCAB), llama.LlamaConfig.tiny(VOCAB)
    ids = _prompt(1, 2, 12)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params)
    jcache = jax_llama.init_cache(cfg_j, 2, 16, jnp.float32)
    tcache = llama.init_cache(cfg_t, 2, 16, torch.float32)
    want, jcache = jax_llama.decode_forward(cfg_j, jp, jnp.asarray(ids[:, :8]), jcache, 0)
    got, tcache = llama.decode_forward(cfg_t, tp, torch.from_numpy(ids[:, :8]), tcache, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for t in range(8, 12):
        want, jcache = jax_llama.decode_forward(cfg_j, jp, jnp.asarray(ids[:, t:t + 1]),
                                                jcache, t)
        # a device scalar start position, as the engine's captured step passes it
        got, tcache = llama.decode_forward(cfg_t, tp, torch.from_numpy(ids[:, t:t + 1]),
                                           tcache, torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), rtol=0,
                                   atol=ATOL)


SAMPLING = {
    "greedy": {},
    "greedy_penalty": dict(repetition_penalty=1.3),
    "tempered": dict(temperature=0.8, seed=3),
    "top_k": dict(temperature=1.1, seed=4, top_k=7),
    "top_p": dict(temperature=0.9, seed=5, top_p=0.8),
    "all": dict(temperature=0.7, seed=6, top_k=20, top_p=0.9, repetition_penalty=1.2),
}


@pytest.mark.parametrize("name", list(SAMPLING))
def test_generate_identical_to_jax(np_params, jax_engine, name):
    eng = _engine(np_params)
    prompt = _prompt()
    kw = SAMPLING[name]
    got = eng.generate(prompt, max_new_tokens=N, **kw)
    want = jax_engine.generate(prompt, max_new_tokens=N, **kw)
    assert got.shape == (B, T + N)
    np.testing.assert_array_equal(got, want)


def test_generate_reuses_its_programs(np_params, jax_engine):
    """A second call with the same statics key builds nothing and runs the
    same two programs (on the card: replays, 0 captures); new sampling
    values are data. A new seed gives the JAX engine's new tokens."""
    eng = _engine(np_params)
    prompt = _prompt(4)
    eng.generate(prompt, max_new_tokens=N, temperature=0.9, seed=1, top_k=9)
    runs = eng.programs.eager_runs
    got = eng.generate(prompt, max_new_tokens=N, temperature=0.6, seed=2, top_k=4)
    assert len(eng._gen_cache) == 1
    assert eng.programs.eager_runs - runs == 1 + N
    assert eng.programs.captures == 0  # the CPU runs every program eagerly
    want = jax_engine.generate(prompt, max_new_tokens=N, temperature=0.6, seed=2, top_k=4)
    np.testing.assert_array_equal(got, want)


def test_forward_matches_jax(np_params, jax_engine):
    ids = _prompt(5, 2, 9)
    got = _engine(np_params).forward(ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_engine.forward(ids)), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("config,item", [
    ({"tensor_parallel": {"tp_size": 2}}, "item 12"),
    ({"mp_size": 2}, "item 12"),
    ({"tensor_parallel": 4}, "item 12"),
])
def test_init_inference_refuses_unported(np_params, config, item):
    with pytest.raises(NotImplementedError, match=item):
        init_inference(llama.build(llama.LlamaConfig.tiny(VOCAB)),
                       {**config, "params": params_from_numpy(np_params), "device": "cpu"})


@pytest.mark.parametrize("config,bits,dtype", [
    ({"dtype": "int8"}, 8, torch.bfloat16),
    ({"quant": {"enabled": True, "weight": {"num_bits": 4}}}, 4, torch.bfloat16),
    ({"quant": "int8"}, 0, torch.bfloat16),  # a KV codec: inert on the dense cache
    ({"quant": "int8+woq4+qcol", "dtype": "fp32"}, 4, torch.float32),
    ({"quantize_bits": 8, "dtype": "fp32"}, 8, torch.float32),
    ({"quant": {"enabled": False}}, 0, torch.bfloat16),
])
def test_init_inference_takes_quantization(np_params, config, bits, dtype):
    """``dtype="int8"``, a ``quant`` section or string and ``quantize_bits``
    build a weight-only quantized engine (the reference's
    ``init_inference``), whose tokens are the JAX engine's
    (tests/test_torch_woq.py)."""
    from deepspeed_tpu_torch.ops.quantizer import QuantizedWeight

    eng = init_inference(llama.build(llama.LlamaConfig.tiny(VOCAB)),
                         {**config, "params": params_from_numpy(np_params), "device": "cpu"})
    assert eng.quantize_bits == bits and eng.dtype == dtype
    wq = eng.params["layers"]["wq"]
    assert isinstance(wq, QuantizedWeight) == bool(bits)
    if bits:
        assert wq.bits == bits and eng.params["embed"].dtype == dtype
    out = eng.generate(_prompt(7, 1, 4), max_new_tokens=2)
    assert out.shape == (1, 6)


@pytest.mark.parametrize("dtype,want", [("fp32", torch.float32), (torch.float32, torch.float32),
                                        ("bf16", torch.bfloat16), (torch.float16, torch.float16),
                                        (None, torch.bfloat16)])
def test_init_inference_dtype(np_params, dtype, want):
    config = {"params": params_from_numpy(np_params), "device": "cpu"}
    if dtype is not None:
        config["dtype"] = dtype
    eng = init_inference(llama.build(llama.LlamaConfig.tiny(VOCAB)), config)
    assert eng.dtype == want and eng.params["embed"].dtype == want
    with pytest.raises(FileNotFoundError):  # loading is ported: a missing tag raises
        eng.load_checkpoint("/nonexistent")


def test_default_device_is_the_card(np_params):
    spec = llama.build(llama.LlamaConfig.tiny(VOCAB))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(spec, params=params_from_numpy(np_params))
        return
    assert InferenceEngine(spec, params=params_from_numpy(np_params)).device == \
        torch.device("cuda", 0)
