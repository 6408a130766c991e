"""Set-up shared by the port's serving-tier tests (tests/test_torch_serving.py,
tests/test_torch_faults.py, tests/test_torch_cluster.py,
tests/test_torch_telemetry.py): the engine sizes of tests/torch_ragged_common.py
in a fused configuration (fused chunks of 4, three in flight, device-resident
state, the prefix cache on), a workload of 8 prompts on two shared 8-token
prefixes, each asked greedy (``g<i>``) and seeded (``s<i>``: temperature
0.8, top-k 20, seed 1000 + i), and the JAX engine's run of it with telemetry
and tracing on, computed once a process (its tokens are every test's
reference; its metrics and spans the telemetry test's). Callers must not
modify what these functions return.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ragged_common as common
from torch_ragged_common import CFG, RCFG

from deepspeed_tpu.inference import ragged as jax_ragged
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.ragged import RaggedConfig, RaggedInferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other engine test files: each test
    file imports this fixture (under xdist, several workers each running
    torch with a thread per core slows every test of the run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SERVE = dict(RCFG, fused_chunk=4, pipeline_depth=3, enable_prefix_cache=True)
MAX_NEW = 8
SEEDED = dict(temperature=0.8, top_k=20)


def prompts() -> list:
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, CFG["vocab_size"], 8).tolist() for _ in range(2)]
    return [prefixes[i % 2] + rng.integers(0, CFG["vocab_size"], 2 + i).tolist()
            for i in range(8)]


def sampling(uid: str) -> dict:
    """The put()/request sampling arguments of ``uid``."""
    return dict(SEEDED, seed=1000 + int(uid[1:])) if uid[0] == "s" else {}


def requests() -> dict:
    """uid -> prompt: g0..g7 greedy, s0..s7 seeded."""
    ps = prompts()
    return {f"{kind}{i}": p for kind in ("g", "s") for i, p in enumerate(ps)}


@functools.cache
def torch_params():
    return params_from_numpy(common.np_params())


def engine(**over) -> RaggedInferenceEngine:
    """A port engine on the CPU at the serving configuration (``over``
    replaces fields), fp32, on the shared weights."""
    return RaggedInferenceEngine(llama.build(llama.LlamaConfig(**CFG)),
                                 RaggedConfig(**{**SERVE, **over}), dtype=torch.float32,
                                 params=torch_params(), device="cpu")


def jax_tokens() -> dict:
    """The JAX engine's tokens for ``requests()`` (``MAX_NEW`` each)."""
    return jax_run()["tokens"]


def jax_run() -> dict:
    """One JAX engine at the serving configuration runs ``requests()``
    (all put at once, then ``generate_all``) with telemetry and tracing on:
    its tokens, engine counters, metrics snapshot and the names of the spans
    its tracer recorded, in order; once a test run
    (``torch_ragged_common.shared``)."""
    return common.shared(_jax_run)


def _jax_run() -> dict:
    """``jax_run``'s computation; the JAX bus is reset afterwards."""
    from deepspeed_tpu import telemetry as jax_telemetry

    jax_telemetry.configure(enabled=True, tracing=True, compile_metrics=False,
                            hbm_watermarks=False)
    try:
        jcfg = jax_llama.LlamaConfig(**CFG)
        eng = jax_ragged.RaggedInferenceEngine(
            lambda ctx: jax_llama.build(jcfg, ctx=ctx), jax_ragged.RaggedConfig(**SERVE),
            dtype=jnp.float32, params=jax.tree_util.tree_map(jnp.asarray, common.np_params()))
        for uid, p in requests().items():
            eng.put(uid, p, max_new_tokens=MAX_NEW, **sampling(uid))
        tokens = eng.generate_all()
        tel = jax_telemetry.get_telemetry()
        return {"tokens": tokens,
                "counters": engine_counters(eng),
                "metrics": tel.registry.snapshot(),
                "spans": [s["name"] for s in tel.tracer.snapshot()]}
    finally:
        jax_telemetry.TELEMETRY.reset()


def leak_free(eng) -> bool:
    """Nothing held: no work, no reservation, every block free or a
    refcount-0 cached block (the prefix cache keeps those)."""
    alloc = eng.allocator
    return (not eng.has_work and eng._reserved == 0 and all(r == 0 for r in alloc._refs)
            and len(alloc._free) + alloc.retained_blocks == eng.cfg.num_blocks - 1
            and len(eng._free_slots) == eng.cfg.max_seqs and not eng.block_tables.any())


def engine_counters(eng) -> dict:
    """The deterministic counters both engines keep."""
    return {k: getattr(eng, k) for k in (
        "dispatch_count", "tokens_scheduled", "tokens_padded", "h2d_bytes", "tokens_emitted",
        "prefix_hits", "prefix_misses", "prefix_tokens_reused")}
