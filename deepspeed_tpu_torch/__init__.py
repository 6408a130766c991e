"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

Each module mirrors its counterpart in ``deepspeed_tpu`` by path and public
name; the JAX package stays the reference the tests hold this one against.
This package imports ``torch``, ``numpy`` and the standard library only.

Two slices are ported. Serving: ``RaggedInferenceEngine`` over the Llama
family, with the paged-decode and tiled-prefill attention kernels. Training:
``initialize`` -> ``Engine.train_batch`` (AdamW/Adam/SGD with optax
semantics, bf16 compute over fp32 masters, clipping, activation
checkpointing, one device), with the flash-attention forward, dK/dV and dQ
kernels. Every kernel is written by hand in CUDA for Hopper (``ops/cuda``).

Exports load lazily so ``import deepspeed_tpu_torch`` stays cheap.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY = {
    "initialize": ("deepspeed_tpu_torch.runtime.engine", "initialize"),
    "Engine": ("deepspeed_tpu_torch.runtime.engine", "Engine"),
    "load_config": ("deepspeed_tpu_torch.config.config", "load_config"),
    "RaggedConfig": ("deepspeed_tpu_torch.inference.ragged", "RaggedConfig"),
    "RaggedInferenceEngine": ("deepspeed_tpu_torch.inference.ragged",
                              "RaggedInferenceEngine"),
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
