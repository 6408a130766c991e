"""Serving and training from checkpoints, and the hybrid engine, against
the JAX package on the CPU (``LlamaConfig.tiny()``, fp32):

- the JAX ``HybridEngine`` trains 2 steps and saves a sharded tag (its
  generation after the first step is the hybrid reference below); a legacy
  single-file tag (``model.npz`` / ``optimizer.npz``, the manifest without
  a file table) is written from the same state with the JAX package's
  ``CheckpointEngine``;
- the port's dense ``InferenceEngine(checkpoint=)`` on each tag: greedy
  tokens identical to the JAX engine's ``InferenceEngine(checkpoint=)``;
  ``load_checkpoint`` on a live engine the same; a woq8 engine on each tag:
  tokens identical to a woq8 engine given the tag's arrays;
- ``zero_to_fp32`` of each tag bitwise the JAX one's (``.npz``, and the
  ``.pt`` written with ``torch.save``);
- ``Engine.load_checkpoint`` of the legacy tag (params, optimizer state,
  loss scale, counters) continues bit for bit as a load of the sharded tag;
- ``HybridEngine`` against the JAX ``HybridEngine`` after one training
  step: greedy and seeded tokens identical, logprobs within 1e-5,
  ``generate_rollouts`` and ``prefill`` / ``decode_more`` identical; the
  cast happens once a step and ``load_checkpoint`` invalidates it.
"""

import functools
import os
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import engine as jax_ckpt
from deepspeed_tpu.checkpoint import serialization as jax_ser
from deepspeed_tpu.checkpoint import zero_to_fp32 as jax_z2f
from deepspeed_tpu.comm.comm import init_distributed as jax_init_distributed
from deepspeed_tpu.comm.topology import reset_topology
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.config.config import load_config as jax_load_config
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.hybrid_engine import HybridEngine as JaxHybridEngine
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_keys
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.engine import initialize
from deepspeed_tpu_torch.runtime.hybrid_engine import HybridEngine
from torch_ragged_common import shared
from torch_serving_common import one_torch_thread  # noqa: F401

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
S = 16
PROMPTS = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 6), dtype=np.int32)
NEW = 6


def _train_config():
    return {"train_micro_batch_size_per_device": 2, "steps_per_print": 0,
            "gradient_clipping": 1.0, "sequence_length": S, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}, "mesh": {"data": 1}}


@functools.cache
def _np_params():
    return jax.tree_util.tree_map(np.array, jax_llama.init_params(JCFG, jax.random.PRNGKey(0)))


def _batches(n):
    rng = np.random.default_rng(9)
    return [{"input_ids": rng.integers(0, CFG.vocab_size, (2, S), dtype=np.int32)}
            for _ in range(n)]


def _one_device():
    reset_topology()
    jax_init_distributed(MeshConfig(data=1), devices=jax.devices()[:1])


def _hybrid_outputs(eng):
    """The JAX HybridEngine's tokens, logprobs and rollouts, as numpy."""
    out = {"greedy": eng.generate(PROMPTS, max_new_tokens=NEW, seed=1, return_logprobs=True),
           "sampled": eng.generate(PROMPTS, max_new_tokens=NEW, temperature=0.8, seed=4,
                                   top_k=20, return_logprobs=True),
           "unseeded": eng.generate(PROMPTS, max_new_tokens=NEW, temperature=0.8,
                                    return_logprobs=True)}
    rolls = eng.generate_rollouts([PROMPTS[0], PROMPTS[1, :4], PROMPTS[1]],
                                  rollout_batch_size=2, max_new_tokens=4, temperature=0.9)
    out["rollouts"] = [r["full"] for r in rolls]
    st = eng.prefill(PROMPTS, max_len=S)
    st = eng.decode_more(eng.decode_more(st, 3), 3)
    out["decode_more"] = st.tokens
    # copies, not views: a numpy view keeps its JAX buffer in jax.live_arrays()
    return {k: (tuple(np.array(x) for x in v) if isinstance(v, tuple) else
                [np.array(x) for x in v] if isinstance(v, list) else np.array(v))
            for k, v in out.items()}


def _jax_side(root):
    """One JAX HybridEngine (an ``Engine``): its generation after the first
    step, then both tags saved after the second; the JAX engines' tokens on
    each tag."""
    reset_topology()
    cfg = jax_load_config(_train_config())
    topo = jax_init_distributed(cfg.mesh, devices=jax.devices()[:1])
    cfg.resolve_batch_sizes(topo.dp_world_size)
    jeng = JaxHybridEngine(lambda ctx: jax_llama.build(JCFG, ctx=ctx), cfg, topo,
                           initial_params=_np_params(), inference_dtype=jnp.float32)
    first, second = _batches(2)
    jeng.train_batch(first)
    hybrid = _hybrid_outputs(jeng)
    jeng.train_batch(second)
    sharded = os.path.join(root, "sharded")
    tag_dir = jeng.save_checkpoint(sharded)
    tag = os.path.basename(str(tag_dir).rstrip("/"))
    legacy = os.path.join(root, "legacy")
    ldir = os.path.join(legacy, tag)
    os.makedirs(ldir)
    manifest = jax_ser.load_json(os.path.join(sharded, tag, "manifest.json"))
    for k in ("files", "commit_protocol"):
        manifest.pop(k, None)
    opt = jax_ser.tree_to_arrays(jeng.opt_state)
    opt.update({f"__scale__{k}": np.asarray(v) for k, v in jeng.scale_state._asdict().items()})
    jax_ckpt.CheckpointEngine().save({"manifest": manifest,
                                      "model": jax_ser.tree_to_arrays(jeng.params),
                                      "optimizer": opt}, ldir)
    jax_ckpt.write_latest(legacy, tag)
    out = {"tag": tag, "dirs": {"sharded": sharded, "legacy": legacy}, "tokens": {},
           "z2f": {}, "hybrid": hybrid}
    _one_device()
    dense = None
    for name, d in out["dirs"].items():
        if dense is None:
            dense = JaxInferenceEngine(jax_llama.build(JCFG), dtype=jnp.float32, checkpoint=d)
        else:  # the same shapes: no second compile
            dense.load_checkpoint(d)
        out["tokens"][name] = np.asarray(dense.generate(PROMPTS, max_new_tokens=NEW))
        out["z2f"][name] = jax_z2f.get_fp32_state_dict_from_checkpoint(d)
    reset_topology()
    return out


def _tags():
    """The JAX side's results and every file it wrote, as bytes (each test
    process writes them back under its own temporary directory)."""
    with tempfile.TemporaryDirectory(prefix="dstpu-ckpt-serve-") as root:
        out = _jax_side(root)
        out["files"] = {}
        for d, _, names in os.walk(root):
            for n in names:
                path = os.path.join(d, n)
                with open(path, "rb") as f:
                    out["files"][os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def tags(tmp_path_factory):
    out = dict(shared(_tags))
    root = tmp_path_factory.mktemp("tags")
    for rel, data in out["files"].items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    out["dirs"] = {name: str(root / name) for name in ("sharded", "legacy")}
    return out


@pytest.mark.parametrize("layout", ["sharded", "legacy"])
def test_dense_engine_loads_jax_tags(tags, layout):
    d = tags["dirs"][layout]
    eng = InferenceEngine(llama.build(CFG), dtype=torch.float32, checkpoint=d, device="cpu")
    np.testing.assert_array_equal(eng.generate(PROMPTS, max_new_tokens=NEW),
                                  tags["tokens"][layout])
    live = InferenceEngine(llama.build(CFG), dtype=torch.float32, device="cpu")
    first = live.generate(PROMPTS, max_new_tokens=NEW)
    live.load_checkpoint(d)
    np.testing.assert_array_equal(live.generate(PROMPTS, max_new_tokens=NEW),
                                  tags["tokens"][layout])
    assert not np.array_equal(first, tags["tokens"][layout])


@pytest.mark.parametrize("layout", ["sharded", "legacy"])
def test_woq8_engine_loads_jax_tags(tags, layout):
    d = tags["dirs"][layout]
    eng = InferenceEngine(llama.build(CFG), dtype=torch.float32, checkpoint=d, quant="woq8",
                          device="cpu")
    arrays = zero_to_fp32.get_fp32_state_dict_from_checkpoint(d)
    nested: dict = {}
    for name, arr in arrays.items():
        *path, leaf = name.split(".")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    ref = InferenceEngine(llama.build(CFG), dtype=torch.float32,
                          params=params_from_numpy(nested, torch.float32), quant="woq8",
                          device="cpu")
    np.testing.assert_array_equal(eng.generate(PROMPTS, max_new_tokens=NEW),
                                  ref.generate(PROMPTS, max_new_tokens=NEW))


@pytest.mark.parametrize("layout", ["sharded", "legacy"])
def test_zero_to_fp32_matches_jax(tags, layout, tmp_path):
    d = tags["dirs"][layout]
    want = tags["z2f"][layout]
    got = zero_to_fp32.get_fp32_state_dict_from_checkpoint(d)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    zero_to_fp32.convert_checkpoint_to_fp32_state_file(d, str(tmp_path / "m.pt"))
    zero_to_fp32.convert_checkpoint_to_fp32_state_file(d, str(tmp_path / "m.npz"))
    pt = torch.load(tmp_path / "m.pt")
    with np.load(tmp_path / "m.npz") as z:
        for k in want:
            np.testing.assert_array_equal(pt[k].numpy(), want[k])
            np.testing.assert_array_equal(z[k], want[k])


def test_engine_loads_legacy_tag_like_sharded(tags):
    """Params, optimizer state, loss scale and counters from ``model.npz`` /
    ``optimizer.npz``: the next step equals a load of the sharded tag's."""
    engines = []
    for layout in ("sharded", "legacy"):
        eng, _, _, _ = initialize(model=partial(llama.build, CFG), config=_train_config(),
                                  seed=3, device="cpu")
        path, _ = eng.load_checkpoint(tags["dirs"][layout])
        assert os.path.basename(path) == tags["tag"] and eng.global_steps == 2
        engines.append(eng)
    batch = _batches(3)[2]
    losses = [e.train_batch(batch) for e in engines]
    assert torch.equal(losses[0], losses[1])
    assert engines[0].opt_state.count == engines[1].opt_state.count == 3
    for (k, p), (_, q) in zip(flatten_with_keys(engines[0].params),
                              flatten_with_keys(engines[1].params)):
        assert torch.equal(p, q), k


# ------------------------------------------------------------------ hybrid
def test_hybrid_engine_matches_jax(tags, tmp_path):
    want = tags["hybrid"]
    cfg = load_config(_train_config())
    cfg.resolve_batch_sizes(1)
    eng = HybridEngine(partial(llama.build, CFG), cfg, initial_params=_np_params(),
                       inference_dtype=torch.float32, device="cpu")
    eng.train_batch(_batches(1)[0])
    for name, kw in (("greedy", dict(seed=1)), ("sampled", dict(temperature=0.8, seed=4,
                                                                  top_k=20)),
                     ("unseeded", dict(temperature=0.8))):
        full, lps = eng.generate(PROMPTS, max_new_tokens=NEW, return_logprobs=True, **kw)
        np.testing.assert_array_equal(full, want[name][0], err_msg=name)
        np.testing.assert_allclose(lps, want[name][1], atol=1e-5, rtol=1e-5, err_msg=name)
    assert eng.eval_casts == 1  # one cast for the step, three generates
    rolls = eng.generate_rollouts([PROMPTS[0], PROMPTS[1, :4], PROMPTS[1]],
                                  rollout_batch_size=2, max_new_tokens=4, temperature=0.9)
    for got, w in zip(rolls, want["rollouts"]):
        np.testing.assert_array_equal(got["full"], w)
    st = eng.prefill(PROMPTS, max_len=S)
    st = eng.decode_more(eng.decode_more(st, 3), 3)
    np.testing.assert_array_equal(st.tokens, want["decode_more"])
    # a load replaces the masters: the next generate casts again, from them
    eng.load_checkpoint(tags["dirs"]["sharded"])
    got = eng.generate(PROMPTS, max_new_tokens=NEW, seed=1)
    assert eng.eval_casts == 2
    np.testing.assert_array_equal(got, tags["tokens"]["sharded"])
