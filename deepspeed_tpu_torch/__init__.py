"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

Each module mirrors its counterpart in ``deepspeed_tpu`` by path and public
name; the JAX package stays the reference the tests hold this one against.
This package imports ``torch``, ``numpy`` and the standard library only.

Two slices are ported. Serving: ``RaggedInferenceEngine`` over the Llama
family, with the paged-decode and tiled-prefill attention kernels, the
dense-cache ``InferenceEngine`` (``init_inference``), and seeded sampling
with the reference's exact threefry draws. Training:
``initialize`` -> ``Engine.train_batch`` (AdamW/Adam/SGD with optax
semantics, bf16 compute over fp32 masters, clipping, activation
checkpointing), data parallel over ``torch.distributed`` with ZeRO stages
0-3, checkpoints in the JAX package's format (a dense engine serves from
one), the forward / backward / step protocol, the self-healing sentinel,
the elastic agent and the hybrid engine, with the
flash-attention forward, dK/dV and dQ kernels. Every kernel is written by hand in CUDA for Hopper (``ops/cuda``).

Exports load lazily so ``import deepspeed_tpu_torch`` stays cheap.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY = {
    "initialize": ("deepspeed_tpu_torch.runtime.engine", "initialize"),
    "Engine": ("deepspeed_tpu_torch.runtime.engine", "Engine"),
    "HybridEngine": ("deepspeed_tpu_torch.runtime.hybrid_engine", "HybridEngine"),
    "load_config": ("deepspeed_tpu_torch.config.config", "load_config"),
    "RaggedConfig": ("deepspeed_tpu_torch.inference.ragged", "RaggedConfig"),
    "RaggedInferenceEngine": ("deepspeed_tpu_torch.inference.ragged",
                              "RaggedInferenceEngine"),
    "InferenceEngine": ("deepspeed_tpu_torch.inference.engine", "InferenceEngine"),
    "init_inference": ("deepspeed_tpu_torch.inference.engine", "init_inference"),
    "llama": ("deepspeed_tpu_torch.models.llama", None),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(module)
    return mod if attr is None else getattr(mod, attr)
