"""Set-up shared by the port's ragged-engine tests (tests/test_torch_ragged.py,
tests/test_torch_ragged_device.py): the sizes of tests/unit/test_ragged.py
(vocab 97, hidden 32, 4 heads, 2 KV heads; budget 16, 3 slots, 4-token
blocks), the weights both packages load, the requests, and the JAX engine's
reference runs. The JAX work is cached per process, so a pytest-xdist worker
that runs tests of both files does each of it once; callers must not modify
what these functions return.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama

CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, num_kv_heads=2, max_seq_len=128)
RCFG = dict(max_tokens_per_step=16, max_seqs=3, block_size=4, num_blocks=49,
            max_blocks_per_seq=16)
# prompt lengths on both sides of block edges, more requests than slots
PROMPT_LENS = (3, 4, 5, 8, 9, 13, 17)
MAX_NEW = 7


@functools.cache
def np_params() -> dict:
    p = jax_llama.init_params(jax_llama.LlamaConfig(**CFG), jax.random.PRNGKey(3))
    # copies, not views: a numpy view keeps its JAX buffer in jax.live_arrays()
    return jax.tree_util.tree_map(np.array, p)


def requests(seed=11, lens=PROMPT_LENS) -> dict:
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(0, CFG["vocab_size"], n).tolist()
            for i, n in enumerate(lens)}


def jax_reference(prefill_tile=0, decode_run_ahead=0, device_state=True, fused_chunk=0,
                  pipeline_depth=2):
    """The JAX engine's run of ``requests()`` (``MAX_NEW`` tokens each) in
    one mode: (tokens by uid, dispatches, scheduled tokens, padded tokens,
    H2D bytes)."""
    return _jax_reference(prefill_tile, decode_run_ahead, device_state, fused_chunk,
                          pipeline_depth)


@functools.cache
def _jax_reference(prefill_tile, decode_run_ahead, device_state, fused_chunk, pipeline_depth):
    jcfg = jax_llama.LlamaConfig(**CFG)
    eng = jax_ragged.RaggedInferenceEngine(
        lambda ctx: jax_llama.build(jcfg, ctx=ctx),
        jax_ragged.RaggedConfig(**RCFG, prefill_tile=prefill_tile,
                                decode_run_ahead=decode_run_ahead, device_state=device_state,
                                fused_chunk=fused_chunk, pipeline_depth=pipeline_depth),
        dtype=jnp.float32, params=jax.tree_util.tree_map(jnp.asarray, np_params()))
    for uid, prompt in requests().items():
        eng.put(uid, prompt, max_new_tokens=MAX_NEW)
    tokens = eng.generate_all()
    return (tokens, eng.dispatch_count, eng.tokens_scheduled, eng.tokens_padded,
            eng.h2d_bytes)
