"""The training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``).

``initialize`` builds an ``Engine`` from a ``ModelSpec`` (or a builder) and
the JSON config; ``Engine.train_batch`` runs one optimizer step, as the JAX
package's does, but eagerly instead of as one compiled program:

- the global batch ``[GAS * mb, S]`` splits into GAS micro-batches the way
  ``_put_gas_batch`` reshapes it;
- per micro-batch: the fp32 masters are cast to the compute dtype (the cast
  is part of the autograd graph), ``loss * scale`` runs backward, and the
  fp32 gradients sum across micro-batches in the masters' ``.grad``;
- ``_update`` (``engine.py:1000``): divide by ``scale * GAS``, check the
  gradients are finite, take the global norm, clip with
  ``min(1, clip / (norm + 1e-6))``, scale the optimizer's updates by
  ``schedule(step)``, and advance the loss scale. A step with non-finite
  gradients leaves params and optimizer state as they were and counts as
  skipped. Reading that flag is the step's one host sync; the loss-scale
  state itself stays on the device.

One device, ZeRO stage 0. The config grammar is complete
(``config/config.py``); features this slice has not ported raise
``NotImplementedError`` naming their ROADMAP item. Checkpoints, the
dataloader module, the FLOPs profiler and telemetry are not ported yet.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.config.config import Config, load_config
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.optimizers import base_lr, build_optimizer
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.lr_schedules import LRScheduler, build_schedule
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

# ---------------------------------------------------------------- remat
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the outputs of matrix
    products, recompute everything else (norms, rope, activations and the
    flash-attention forward kernel, whose outputs are not products)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


dots_saveable = partial(create_selective_checkpoint_contexts, _save_dots)

# config name -> context_fn for torch.utils.checkpoint; None saves nothing
# but each layer's input. "offload_dots" names a JAX policy that does not
# exist, so the JAX package falls back to dots_saveable, and so does this.
REMAT_POLICIES = {
    "full": None,
    "dots_saveable": dots_saveable,
    "nothing_saveable": None,
    "offload_dots": dots_saveable,
}


def resolve_remat_policy(name: str):
    """Policy name -> ``context_fn``; an unknown name saves nothing, as in
    the JAX package (``engine.py:63-70``)."""
    return REMAT_POLICIES.get(name)


# --------------------------------------------------------- unported features
def _unported(cfg: Config) -> list[tuple[str, str]]:
    """(feature, ROADMAP item) for every feature the config turns on that
    this slice has not ported."""
    z = cfg.zero_optimization
    sp = cfg.sequence_parallel
    mesh = [getattr(cfg.mesh, a) for a in ("data", "fsdp", "tensor", "sequence",
                                           "expert", "pipeline")]
    multi = "queue 1 item 10 (multi-GPU training)"
    rest = "queue 1 item 14 (telemetry and the control plane)"
    checks = [
        (z.stage > 0, "zero_optimization.stage > 0", multi),
        (z.mics_shard_size > 0 or z.hierarchical_partitioning,
         "zero_optimization MiCS / hpZ", multi),
        (z.grad_overlap.enabled, "zero_optimization.grad_overlap", multi),
        (z.quantized_gradients or z.quantized_weights,
         "ZeRO++ qgZ / qwZ (quantized_gradients, quantized_weights)", multi),
        (any(n > 1 for n in mesh), "a mesh of more than one device", multi),
        (cfg.comms_logger.enabled, "comms_logger", multi),
        (cfg.sentinel.enabled, "sentinel", multi),
        (z.offload_optimizer.device != "none" or z.offload_param.device != "none",
         "zero_optimization offload", "queue 1 item 13 (offload tiers)"),
        (z.zenflow.enabled, "zero_optimization.zenflow", "queue 1 item 13 (offload tiers)"),
        (cfg.moe.enabled, "moe", "queue 1 item 11 (other models)"),
        (cfg.pipeline.stages > 1, "pipeline.stages > 1",
         "queue 1 item 12 (parallelism beyond ZeRO)"),
        (cfg.tensor_parallel.enabled, "tensor_parallel",
         "queue 1 item 12 (parallelism beyond ZeRO)"),
        (sp.auto or sp.tiled_mlp or sp.tiled_logits or sp.fpdt_chunks > 0,
         "sequence_parallel (auto, tiled_mlp, tiled_logits, fpdt_chunks)",
         "queue 1 item 12 (parallelism beyond ZeRO)"),
        (cfg.telemetry.enabled, "telemetry", rest),
        (cfg.monitor.enabled, "monitor", rest),
        (cfg.flops_profiler.enabled, "flops_profiler", rest),
        (cfg.tracing.enabled, "tracing", rest),
        (cfg.autotuning.enabled, "autotuning", rest),
        (cfg.eigenvalue.enabled, "eigenvalue", rest),
        (bool(cfg.compression_training), "compression_training", rest),
        (cfg.progressive_layer_drop.enabled, "progressive_layer_drop", rest),
        (cfg.data_efficiency.random_ltd.enabled, "data_efficiency.random_ltd", rest),
    ]
    return [(name, item) for on, name, item in checks if on]


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


class Engine:
    """Config-driven training engine over a ModelSpec, on one device."""

    def __init__(self, model: ModelSpec | Callable[..., ModelSpec], config: Config,
                 training_data: Iterator | None = None, seed: int | None = None,
                 initial_params: Any = None, device=None):
        self.device = resolve_device(device)
        missing = _unported(config)
        if missing:
            raise NotImplementedError(
                "not ported to deepspeed_tpu_torch yet: "
                + "; ".join(f"{name} (ROADMAP.md {item})" for name, item in missing))
        self.config = config
        ac = config.activation_checkpointing
        if isinstance(model, ModelSpec):
            self.model_spec = model
        else:
            self.model_spec = model(remat=ac.enabled,
                                    remat_policy=resolve_remat_policy(ac.policy))
        self.training_dataloader = training_data
        self.gas = int(config.gradient_accumulation_steps)

        # ---- params: fp32 masters on the device
        seed = seed if seed is not None else config.seed
        if initial_params is not None:
            self.params = params_from_numpy(initial_params, torch.float32, self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = self.model_spec.init_fn(gen, torch.float32, self.device)
        self._leaves = _leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)

        # ---- optimizer (lr = 1.0; the schedule scales the updates each step)
        self._base_lr = base_lr(config.optimizer)
        self.lr_schedule = build_schedule(config.scheduler, self._base_lr)
        self.optimizer = build_optimizer(config.optimizer, learning_rate=1.0)
        self.opt_state = self.optimizer.init(self._leaves)
        self.scale_state = precision.init_loss_scale(config.fp16, self.device)
        self.lr_scheduler = LRScheduler(self.lr_schedule)

        self.global_steps = 0
        self.skipped_steps = 0
        self._last_metrics: dict = {}
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        self.tput_timer = ThroughputTimer(batch_size=config.train_batch_size or 1,
                                          steps_per_output=config.steps_per_print,
                                          synchronize=sync)
        if self.model_spec.flops_per_token and config.sequence_length:
            self.tput_timer.flops_per_sample = (
                self.model_spec.flops_per_token(config.sequence_length)
                * config.sequence_length)

    # ------------------------------------------------------------------ step
    def _put_gas_batch(self, batch: dict) -> dict:
        """[B_global, ...] -> [GAS, micro, ...] on the device."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if t.shape[0] % self.gas:
                raise ValueError(
                    f"batch dim {t.shape[0]} not divisible by GAS {self.gas} for '{k}'")
            out[k] = t.reshape((self.gas, t.shape[0] // self.gas) + tuple(t.shape[1:])
                               ).to(self.device)
        return out

    def _gas_grads(self, batch: dict) -> torch.Tensor:
        """Scaled-loss backward per micro-batch; fp32 gradients accumulate in
        the masters' ``.grad``. Returns the mean micro-batch loss."""
        scale = self.scale_state.scale
        for p in self._leaves:
            p.grad = None
        losses = []
        for g in range(self.gas):
            mb = {k: v[g] for k, v in batch.items()}
            cparams = precision.cast_to_compute(self.params, self.config.compute_dtype)
            loss = self.model_spec.loss_fn(cparams, mb)
            (loss * scale).backward()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def _update(self, grads: list, n_micro: float, step: int) -> dict:
        cfg = self.config
        scale = self.scale_state.scale
        torch._foreach_div_(grads, scale * n_micro)
        finite = precision.grads_finite(grads)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if cfg.gradient_clipping > 0:
            torch._foreach_mul_(grads, torch.clamp(
                cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        lr = self.lr_schedule(step)
        skipped = not bool(finite)  # the step's one host sync
        if not skipped:
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                            self._leaves)
            torch._foreach_mul_(updates, lr)
            torch._foreach_add_(self._leaves, updates)
        self.scale_state = precision.update_loss_scale(self.scale_state, finite, cfg.fp16)
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": scale, "skipped": skipped}

    def train_batch(self, batch: dict | None = None, data_iter: Iterator | None = None):
        """One optimizer step over GAS micro-batches; returns the mean
        micro-batch loss as a 0-d tensor."""
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch needs a batch, data_iter, or training_data")
                data_iter = self.training_dataloader
            micro = [next(data_iter) for _ in range(self.gas)]
            batch = {k: np.concatenate([np.asarray(m[k]) for m in micro]) for k in micro[0]}
        dev_batch = self._put_gas_batch(batch)
        self.tput_timer.start()
        loss = self._gas_grads(dev_batch)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._leaves]
        metrics = self._update(grads, float(self.gas), self.global_steps)
        for p in self._leaves:
            p.grad = None
        metrics["loss"] = loss
        self.tput_timer.stop(global_step=True)
        self._after_step(metrics)
        return loss

    def _after_step(self, metrics: dict) -> None:
        self.global_steps += 1
        self.skipped_steps += int(metrics["skipped"])
        self.lr_scheduler.step()
        self._last_metrics = metrics
        if metrics["skipped"] and self.config.fp16.enabled:
            log_dist(f"step {self.global_steps}: overflow, skipping update "
                     f"(loss_scale -> {self.loss_scale})", ranks=[0])
        if self.config.steps_per_print and self.global_steps % self.config.steps_per_print == 0:
            skip = f"skipped={self.skipped_steps} " if self.skipped_steps else ""
            log_dist(f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                     f"lr={metrics['lr']:.3e} grad_norm={float(metrics['grad_norm']):.3f} "
                     f"{skip}", ranks=[0])

    # ------------------------------------------------------------ accessors
    @property
    def loss_scale(self) -> float:
        return float(self.scale_state.scale)

    def get_lr(self):
        return [float(self.lr_schedule(max(0, self.global_steps - 1)))]

    def get_global_grad_norm(self) -> float:
        gn = self._last_metrics.get("grad_norm")
        return float(gn) if gn is not None else 0.0

    @property
    def train_batch_size(self) -> int:
        return int(self.config.train_batch_size)

    def module_state(self):
        return self.params


def initialize(model: ModelSpec | Callable[..., ModelSpec] | None = None,
               config: Config | dict | str | None = None,
               training_data: Iterator | None = None, seed: int | None = None,
               initial_params: Any = None, device=None):
    """Build the engine (counterpart of ``deepspeed_tpu.initialize``).

    ``model``: a ``ModelSpec``, or a builder called as
    ``model(remat=..., remat_policy=...)`` with the config's activation
    checkpointing. ``initial_params``: a nested dict of numpy arrays (fp32
    masters are made from it). ``device``: ``None`` is ``cuda:0`` and raises
    without a card; pass ``"cpu"`` for the plain path on the CPU.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    if model is None:
        raise ValueError("initialize() requires a model (ModelSpec or builder callable)")
    cfg = load_config(config)
    cfg.resolve_batch_sizes(1)
    engine = Engine(model, cfg, training_data=training_data, seed=seed,
                    initial_params=initial_params, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
