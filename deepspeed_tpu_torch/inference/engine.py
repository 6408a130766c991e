"""Dense-cache inference engine (counterpart of
``deepspeed_tpu/inference/engine.py``): padded-batch generation over a
``ModelSpec``'s ``init_cache_fn`` / ``decode_fn``, on one device.

``generate`` keys its work by the reference's statics, (batch, prompt
length, new tokens, sampled?, penalized?, top-k?, top-p?), and builds per
key one program pair over buffers it keeps: a prefill (the cache zeroed,
the prompt's forward, the occurrence mask over the prompt) and a decode
step (pick the next token with key ``fold_in(PRNGKey(seed), i)``, mark it
seen, run it through the model at position ``T + i``, store it). ``i`` and
the position are device scalars, so one decode step serves every
position. On a CUDA device each program runs eagerly the first time and
is captured as a CUDA graph (``inference/cuda_graphs.py``), and replayed
from then on, as the reference compiles one program a signature; the
sampling values (temperature, top-k, top-p, penalty, seed) are written
into the buffers, so changing them captures nothing.

Weight-only quantization (``quantize_bits`` 8 or 4, or ``quant``'s
``woq8`` / ``woq4``; ``init_inference``'s ``dtype="int8"`` and ``quant``
section) keeps the weights int8 / int4 (``ops/quantizer.py``), dequantized
a layer at a time inside the programs. A KV codec in ``quant`` applies to
the paged pool of ``RaggedInferenceEngine`` and is inert here, as is
``qcol`` on one device; both are logged.

``checkpoint=`` (or ``load_checkpoint``) loads the model tree of a
training checkpoint (the ``latest`` tag's, sharded or legacy, written by
either package) leaf by leaf, in slices along the first dimension, straight
into the inference dtype on the device: no fp32 copy of the model exists on
the device or the host. A WOQ engine loads dense weights and quantizes them.

Not ported yet, and refused: tensor parallelism (``ROADMAP.md`` queue 1
item 12). The telemetry span waits for item 14.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.inference import kvquant
from deepspeed_tpu_torch.inference.cuda_graphs import ProgramCache
from deepspeed_tpu_torch.inference.ragged import cast_params
from deepspeed_tpu_torch.inference.sampling import sample_tokens, update_seen
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.ops.quantizer import quantize_params
from deepspeed_tpu_torch.utils import prng
from deepspeed_tpu_torch.utils.logging import log_dist


class _Generation:
    """One statics key's buffers and its two programs; see the module
    docstring. The programs refer to the engine's tensors, not to the
    engine, which keeps them."""

    def __init__(self, spec: ModelSpec, params, dtype, device, b: int, t: int, n: int,
                 sample: bool, use_penalty: bool, has_tk: bool, has_tp: bool):
        self.spec, self.params = spec, params
        self.t, self.sample, self.use_penalty = t, sample, use_penalty
        self.has_tk, self.has_tp = has_tk, has_tp
        vocab = spec.config.vocab_size
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.tokens = torch.zeros((b, t), **i32)
        self.rng = torch.zeros(2, dtype=torch.int64, device=device)
        self.temperature, self.top_p, self.penalty = (torch.zeros((), **f32) for _ in range(3))
        self.top_k = torch.zeros((), **i32)
        self.cache = spec.init_cache_fn(b, t + n, dtype, device)
        self.last = torch.zeros((b, vocab), **f32)
        self.seen = torch.zeros((b, vocab if use_penalty else 1), dtype=torch.bool,
                                device=device)
        self.i = torch.zeros((), dtype=torch.int64, device=device)
        self.out = torch.zeros((b, n), **i32)
        self.rows = torch.arange(b, device=device)[:, None]

    def prefill(self) -> torch.Tensor:
        for buf in self.cache.values():
            buf.zero_()
        logits, _ = self.spec.decode_fn(self.params, self.tokens, self.cache, 0)
        self.last.copy_(logits[:, self.t - 1].float())
        if self.use_penalty:  # everything in the prompt counts as seen
            self.seen.zero_()
            self.seen.index_put_((self.rows, self.tokens.long()),
                                 torch.ones_like(self.tokens, dtype=torch.bool))
        self.i.zero_()
        return self.last

    def _pick(self, key) -> torch.Tensor:
        if not self.sample and not self.use_penalty:
            return torch.argmax(self.last, dim=-1).to(torch.int32)
        return sample_tokens(
            self.last, key, self.temperature if self.sample else 0.0,
            top_k=self.top_k if self.has_tk else None,
            top_p=self.top_p if self.has_tp else None,
            repetition_penalty=self.penalty if self.use_penalty else None,
            seen_mask=self.seen if self.use_penalty else None)[0]

    def step(self) -> torch.Tensor:
        tok = self._pick(prng.fold_in(self.rng, self.i))
        if self.use_penalty:
            update_seen(self.seen, tok)
        logits, _ = self.spec.decode_fn(self.params, tok[:, None], self.cache, self.t + self.i)
        self.last.copy_(logits[:, 0].float())
        self.out.index_copy_(1, self.i.reshape(1), tok[:, None])
        self.i.add_(1)
        return self.out


class InferenceEngine:
    """Greedy and sampled autoregressive generation over a ``ModelSpec``
    with dense-cache hooks. Runs on ``cuda:0`` unless ``device`` names
    another device; without a CUDA device and without ``device`` it
    raises. ``params`` (the stacked layout of ``models/llama.py``) are used
    in place when they already have ``dtype`` and lie on the device, so
    engines can share one weight set; ``quantize_bits`` (or ``quant``'s
    ``woqN``) quantizes them in blocks of ``quantize_block``."""

    def __init__(self, model: ModelSpec, mp_size: int = 1, dtype=torch.bfloat16,
                 params: Any = None, checkpoint: str | None = None, seed: int = 0,
                 quantize_bits: int = 0, quantize_block: int = 256, quant: str = "off",
                 device=None):
        if mp_size > 1:
            raise NotImplementedError(
                "tensor-parallel inference (mp_size > 1) is not ported yet: "
                "ROADMAP.md queue 1 item 12 (parallelism beyond ZeRO)")
        parsed = kvquant.parse_quant(quant)
        self.device = resolve_device(device)
        self.spec = model
        if self.spec.decode_fn is None or self.spec.init_cache_fn is None:
            raise ValueError(f"model {self.spec.name} has no decode/cache support")
        self.dtype = dtype
        if checkpoint is not None:
            params = load_model_tree(checkpoint, self._template(), dtype, self.device)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.spec.init_fn(gen, dtype, self.device)
        self.params = cast_params(params, dtype, self.device)
        if parsed.kv is not None:
            log_dist(f"InferenceEngine: quant KV codec {parsed.kv.name!r} applies to the paged "
                     "pool (RaggedInferenceEngine); inert on the dense-cache engine", ranks=[0])
        if parsed.qcol:
            log_dist("InferenceEngine: quant '+qcol' quantizes tensor-parallel collectives; "
                     "one device has none, so it is ignored", ranks=[0])
        self.quantize_bits = int(quantize_bits) or parsed.woq_bits
        self._quantize_block = quantize_block
        if self.quantize_bits:
            self.params = self._quantize(self.params)
        self.programs = ProgramCache(self.device)
        self._gen_cache: dict = {}
        log_dist(f"InferenceEngine: model={self.spec.name} device={self.device} "
                 f"dtype={str(dtype).replace('torch.', '')}"
                 + (f" woq=int{self.quantize_bits}" if self.quantize_bits else ""), ranks=[0])

    def _quantize(self, params):
        return quantize_params(params, bits=self.quantize_bits, block=self._quantize_block,
                               skip=tuple(self.spec.woq_skip))

    def _template(self):
        """The model's leaves as meta tensors: shapes, no memory."""
        return self.spec.init_fn(None, self.dtype, torch.device("meta"))

    def load_checkpoint(self, ckpt_dir: str) -> None:
        """Load the model tree saved by ``Engine.save_checkpoint`` (either
        package; sharded or legacy) into new weights in the inference dtype
        (``engine.py:134``); a WOQ engine quantizes them. The programs built
        so far referred to the old weights and are dropped."""
        params = load_model_tree(ckpt_dir, self._template(), self.dtype, self.device)
        self.params = self._quantize(params) if self.quantize_bits else params
        self.programs = ProgramCache(self.device)
        self._gen_cache = {}

    def generate(self, input_ids, max_new_tokens: int = 64, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                 repetition_penalty: float = 1.0) -> np.ndarray:
        """[B, T] prompt -> [B, T + max_new_tokens] (greedy when temperature
        is 0). Each (B, T, N, sampled?, penalized?, top-k?, top-p?) key
        builds its programs once (on the card: captures them) and replays
        them after; the sampling values are data, so changing them builds
        nothing."""
        input_ids = np.asarray(input_ids)
        b, t = input_ids.shape
        sample = temperature > 0.0
        use_penalty = repetition_penalty != 1.0
        has_tk, has_tp = top_k > 0, top_p < 1.0
        key = (b, t, max_new_tokens, sample, use_penalty, has_tk, has_tp)
        gen = self._gen_cache.get(key)
        if gen is None:
            gen = self._gen_cache[key] = _Generation(self.spec, self.params, self.dtype,
                                                     self.device, *key)
        gen.tokens.copy_(torch.from_numpy(input_ids.astype(np.int32)))
        gen.rng.copy_(prng.prng_key(seed))
        gen.temperature.fill_(max(temperature, 1e-6))
        gen.top_k.fill_(top_k)
        gen.top_p.fill_(top_p)
        gen.penalty.fill_(repetition_penalty)
        self.programs.run(("prefill", *key), gen.prefill)
        for _ in range(max_new_tokens):
            self.programs.run(("decode", *key), gen.step)
        toks = gen.out.cpu().numpy()
        return np.concatenate([input_ids, toks], axis=1)

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """Plain logits forward: [B, S] tokens -> [B, S, V]."""
        return self.spec.forward_fn(self.params,
                                    torch.as_tensor(np.asarray(input_ids), device=self.device))

    __call__ = forward


_KEY_PART = re.compile(r"\['([^']*)'\]")
_LOAD_SLICE_BYTES = 64 << 20  # a leaf crosses to the device in slices of about this


def load_model_tree(ckpt_dir: str, template, dtype: torch.dtype, device) -> dict:
    """The ``model`` tree of the ``latest`` tag under ``ckpt_dir`` (or of
    ``ckpt_dir`` itself; ``checkpoint.engine.model_tree`` reads it a leaf at
    a time), as new tensors in ``dtype`` on ``device`` shaped and keyed as
    ``template`` (a tree of tensors, meta ones do). Each leaf is copied in
    slices along its first dimension, each slice cast on the way in: no fp32
    copy of the whole model is made."""
    from deepspeed_tpu_torch.checkpoint import engine as ckpt

    want = dict(ser.flatten_with_keys(template))
    loaded: dict = {}
    for key, arr in ckpt.model_tree(ckpt_dir):
        leaf = want.get(key)
        if leaf is None:
            continue
        shape = tuple(leaf.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {key} shape {tuple(arr.shape)} != "
                             f"expected {shape}")
        t = torch.empty(shape, dtype=dtype if leaf.is_floating_point() else leaf.dtype,
                        device=device)
        if arr.ndim == 0:
            t.copy_(torch.tensor(arr.item()))
        else:
            rows = max(1, _LOAD_SLICE_BYTES // max(1, arr[0].nbytes))
            for i in range(0, shape[0], rows):
                t[i:i + rows].copy_(torch.from_numpy(np.array(arr[i:i + rows])))
        loaded[key] = t
        del arr
    out: dict = {}
    for key in want:  # the template's order
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key}")
        node = out
        path = _KEY_PART.findall(key)
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = loaded[key]
    return out


_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp16": torch.float16,
           "float16": torch.float16, "half": torch.float16, "fp32": torch.float32,
           "float32": torch.float32, "float": torch.float32}


def init_inference(model: ModelSpec, config: dict | None = None, **kwargs) -> InferenceEngine:
    """``deepspeed.init_inference`` (the reference's ``:287``): the config
    dict, updated by ``kwargs``, names ``tensor_parallel`` / ``mp_size``,
    ``dtype`` (a string or a torch dtype; unknown names give bf16, as in
    the reference), ``params``, ``checkpoint``, the quantization knobs and
    ``device``. ``dtype="int8"`` (bf16 compute) and a ``quant`` section
    (``{"weight": {"num_bits": 8 or 4}}``, or a ``RaggedConfig.quant``
    string) ask for weight-only quantization."""
    config = dict(config or {})
    config.update(kwargs)
    tp = config.get("tensor_parallel", {})
    mp_size = tp.get("tp_size", config.get("mp_size", 1)) if isinstance(tp, dict) else int(tp)
    dtype_str = str(config.get("dtype", "bf16")).replace("torch.", "")
    bits = 8 if dtype_str in ("int8", "qint8") else 0
    quant = config.get("quant")
    quant_str = "off"
    if isinstance(quant, str):
        quant_str = quant
    elif isinstance(quant, dict) and quant.get("enabled", True):
        bits = int((quant.get("weight") or {}).get("num_bits", bits or 8))
    return InferenceEngine(
        model, mp_size=mp_size, dtype=_DTYPES.get(dtype_str, torch.bfloat16),
        params=config.get("params"), checkpoint=config.get("checkpoint"),
        quantize_bits=int(config.get("quantize_bits", bits)),
        quantize_block=int(config.get("quantize_block", 256)), quant=quant_str,
        device=config.get("device"))
