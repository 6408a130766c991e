"""The port's config grammar against the JAX package's, field by field.

The same JSON dicts go through ``deepspeed_tpu.config.config.load_config``
and ``deepspeed_tpu_torch.config.config.load_config``; the parsed trees must
be equal (``to_dict()``), the batch triangle must resolve the same, and a
bad config must fail with the same message. Also: the engine refuses the
features this slice has not ported, naming their ROADMAP item.
"""

from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.config import config as jcfg
from deepspeed_tpu_torch.config import config as tcfg
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.runtime.engine import initialize

CONFIGS = {
    "bench_train": {
        "train_micro_batch_size_per_device": 2, "gradient_accumulation_steps": 1,
        "steps_per_print": 0, "gradient_clipping": 1.0, "sequence_length": 4096,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
        "zero_optimization": {"stage": 0}, "mesh": {"data": -1},
        "activation_checkpointing": {"enabled": True, "policy": "dots_saveable"},
    },
    "aliases": {
        "train_micro_batch_size_per_gpu": 4, "train_batch_size": 32,
        "zero": {"stage": 2, "cpu_offload": True},
        "fp16": {"enabled": True, "initial_scale_power": 12, "hysteresis": 3},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
    },
    "auto": {
        "train_batch_size": "auto", "train_micro_batch_size_per_device": 8,
        "gradient_accumulation_steps": "auto", "bf16": {"enabled": False},
        "zenflow": {"topk_ratio": 0.1},
    },
    "full_sections": {
        "train_batch_size": 64, "gradient_accumulation_steps": 4,
        "optimizer": {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9}},
        "sequence_parallel": {"mode": "ring", "tile_size": 512},
        "pipeline": {"stages": 0, "schedule": "1f1b"},
        "telemetry": {"enabled": False}, "monitor": {"enabled": False},
        "data_efficiency": {"random_ltd": {"enabled": False}},
    },
}

BAD = {
    "unknown_key": {"train_batch_size": 8, "bogus": 1},
    "auto_not_allowed": {"train_batch_size": 8, "gradient_clipping": "auto"},
    "fp16_and_bf16": {"train_batch_size": 8, "fp16": {"enabled": True},
                      "bf16": {"enabled": True}},
    "bad_optimizer": {"train_batch_size": 8, "optimizer": {"type": "adamax"}},
    "wrong_type": {"train_batch_size": 8, "steps_per_print": "often"},
}

TRIANGLES = [  # (train_batch_size, micro, gas, dp_world)
    (32, 4, None, 2), (32, None, 4, 2), (None, 4, 2, 2), (16, None, None, 4),
    (24, 3, 4, 2), ("auto", 6, "auto", 1),
]
BAD_TRIANGLES = [(30, 4, None, 2), (24, 3, 3, 2), (None, None, 2, 1)]


def _tri(tb, mb, gas):
    d = {}
    for key, val in (("train_batch_size", tb), ("train_micro_batch_size_per_device", mb),
                     ("gradient_accumulation_steps", gas)):
        if val is not None:
            d[key] = val
    return d


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parses_like_jax(name):
    want = jcfg.load_config(CONFIGS[name])
    got = tcfg.load_config(CONFIGS[name])
    assert got.to_dict() == want.to_dict()
    assert got.precision_name == want.precision_name
    assert got.mesh.is_explicit == want.mesh.is_explicit


@pytest.mark.parametrize("name", list(BAD))
def test_errors_like_jax(name):
    with pytest.raises(jcfg.ConfigError) as want:
        jcfg.load_config(BAD[name])
    with pytest.raises(tcfg.ConfigError) as got:
        tcfg.load_config(BAD[name])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tb,mb,gas,dp", TRIANGLES)
def test_batch_triangle_like_jax(tb, mb, gas, dp):
    want, got = jcfg.load_config(_tri(tb, mb, gas)), tcfg.load_config(_tri(tb, mb, gas))
    want.resolve_batch_sizes(dp)
    got.resolve_batch_sizes(dp)
    for key in ("train_batch_size", "train_micro_batch_size_per_device",
                "gradient_accumulation_steps"):
        assert getattr(got, key) == getattr(want, key)


@pytest.mark.parametrize("tb,mb,gas,dp", BAD_TRIANGLES)
def test_bad_batch_triangle_like_jax(tb, mb, gas, dp):
    with pytest.raises(jcfg.ConfigError) as want:
        jcfg.load_config(_tri(tb, mb, gas)).resolve_batch_sizes(dp)
    with pytest.raises(tcfg.ConfigError) as got:
        tcfg.load_config(_tri(tb, mb, gas)).resolve_batch_sizes(dp)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("section,want", [
    ({}, (jnp.bfloat16, torch.bfloat16)),
    ({"bf16": {"enabled": False}}, (jnp.float32, torch.float32)),
    ({"fp16": {"enabled": True}}, (jnp.float16, torch.float16)),
])
def test_compute_dtype(section, want):
    assert jcfg.load_config(section).compute_dtype == want[0]
    assert tcfg.load_config(section).compute_dtype == want[1]


@pytest.mark.parametrize("section,item", [
    ({"zero_optimization": {"grad_overlap": {"enabled": True}}}, "item 10"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, "item 13"),
    ({"telemetry": {"enabled": True}}, "item 14"),
    ({"sequence_parallel": {"tiled_logits": True}}, "item 12"),
    ({"zero_optimization": {"quantized_gradients": True}}, "item 10"),
    ({"optimizer": {"type": "lion"}}, "item 15"),
    ({"optimizer": {"type": "onebit_adam"}}, "item 10"),
])
def test_engine_refuses_unported_features(section, item):
    cfg = {"train_micro_batch_size_per_device": 1, **section}
    with pytest.raises(NotImplementedError, match=item):
        initialize(model=partial(llama.build, llama.LlamaConfig.tiny()), config=cfg,
                   device="cpu")


def test_mesh_larger_than_the_world_raises_like_jax():
    """``{"mesh": {"data": 2}}`` in a one-process run: the topology's
    ``ValueError``, with the JAX builder's message."""
    from deepspeed_tpu.comm.topology import MeshTopology as JaxMeshTopology

    with pytest.raises(ValueError) as want:
        JaxMeshTopology.build(jcfg.load_config({"mesh": {"data": 2}}).mesh,
                              devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        initialize(model=partial(llama.build, llama.LlamaConfig.tiny()),
                   config={"train_micro_batch_size_per_device": 1, "mesh": {"data": 2}},
                   device="cpu")
    assert str(got.value) == str(want.value)
