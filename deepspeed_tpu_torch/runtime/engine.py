"""The training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``).

``initialize`` joins the process group (``comm.init_distributed``), lays
the config's mesh over it, resolves the batch triangle for its DP world
and builds an ``Engine`` from a ``ModelSpec`` (or a builder).
``Engine.train_batch`` runs one optimizer step, as the JAX package's does,
but eagerly instead of as one compiled program:

- the global batch ``[GAS * mb * dp, S]`` splits into GAS micro-batches the
  way ``_put_gas_batch`` reshapes it, and each rank takes its rows of each;
- per micro-batch: the fp32 masters are cast to the compute dtype (the cast
  is part of the autograd graph), the rank's loss, weighted by its share of
  the micro-batch's target tokens and by the loss scale, runs backward, and
  the fp32 gradients sum across micro-batches in the masters' ``.grad``;
- at the accumulation boundary the gradients sum across ranks: all-reduce
  at ZeRO stages 0-1, reduce-scatter over ``fsdp`` at stage 2, and at
  stage 3 the gather's backward has reduce-scattered them already
  (``parallel/partition.py`` plans which leaves are sharded);
- ``_update`` (``engine.py:1000``): divide by ``scale * GAS``, check the
  gradients are finite and take the global norm (both reduced across
  shards), clip with ``min(1, clip / (norm + 1e-6))``, scale the
  optimizer's updates by ``schedule(step)`` and advance the loss scale. The
  optimizer updates each rank's own shards (stages 1-2 then all-gather the
  masters). A step with non-finite gradients leaves params and optimizer
  state as they were, on every rank, and counts as skipped. Reading that
  flag is the step's one host sync.

Stage 3 keeps only each rank's shard of the masters and gathers a leaf
where the model uses it (``_GatherShard``: all-gather in the forward,
reduce-scatter of the gradient in the backward), a layer's weights inside
its checkpointed function, so the recompute gathers again.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) are the JAX
package's format and protocol (``checkpoint/``): either package loads the
other's, at any world size and stage. Features this slice has not ported
raise ``NotImplementedError`` naming their ROADMAP item; the dataloader
module, the FLOPs profiler and telemetry's training spans are not ported.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.topology import AXIS_DATA, AXIS_FSDP, MeshTopology
from deepspeed_tpu_torch.config.config import Config, load_config
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.optimizers import base_lr, build_optimizer
from deepspeed_tpu_torch.parallel.partition import plan_sharding
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.lr_schedules import LRScheduler, build_schedule
from deepspeed_tpu_torch.utils import prng
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

BATCH = (AXIS_DATA, AXIS_FSDP)  # the DP world this slice runs

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
    model_axes = [getattr(cfg.mesh, a) for a in ("tensor", "sequence", "expert", "pipeline")]
    multi = "queue 1 item 10, second part (the rest of multi-GPU training)"
    beyond = "queue 1 item 12 (parallelism beyond ZeRO)"
    rest = "queue 1 item 14 (telemetry and the control plane)"
    checks = [
        (z.mics_shard_size > 0 or z.hierarchical_partitioning,
         "zero_optimization MiCS / hpZ", multi),
        (z.grad_overlap.enabled, "zero_optimization.grad_overlap", multi),
        (z.quantized_gradients or z.quantized_weights,
         "ZeRO++ qgZ / qwZ (quantized_gradients, quantized_weights)", multi),
        (cfg.sentinel.enabled, "sentinel", multi),
        (any(n > 1 for n in model_axes),
         "a tensor, sequence, expert or pipeline mesh axis above 1", beyond),
        (z.offload_optimizer.device != "none" or z.offload_param.device != "none",
         "zero_optimization offload", "queue 1 item 13 (offload tiers)"),
        (z.zenflow.enabled, "zero_optimization.zenflow", "queue 1 item 13 (offload tiers)"),
        (cfg.moe.enabled, "moe", "queue 1 item 11 (other models)"),
        (cfg.pipeline.stages > 1, "pipeline.stages > 1", beyond),
        (cfg.tensor_parallel.enabled, "tensor_parallel", beyond),
        (sp.auto or sp.tiled_mlp or sp.tiled_logits or sp.fpdt_chunks > 0,
         "sequence_parallel (auto, tiled_mlp, tiled_logits, fpdt_chunks)", beyond),
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


def _refuse_unported(cfg: Config) -> None:
    missing = _unported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to deepspeed_tpu_torch yet: "
            + "; ".join(f"{name} (ROADMAP.md {item})" for name, item in missing))


def _map_tree(tree, fn, prefix=()):
    """``fn(keystr, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, prefix + (k,)) for k, v in tree.items()}
    return fn(ser.keystr(prefix), tree)


def _target_count(batch: dict) -> int:
    """Target tokens of a causal-LM micro-batch: ``labels != -100`` when the
    batch has labels, else every position but the last of each row (the
    denominator of ``causal_lm_loss``)."""
    if "labels" in batch:
        return int((np.asarray(batch["labels"]) != -100).sum())
    ids = np.asarray(batch["input_ids"])
    return int(ids.shape[0] * max(ids.shape[1] - 1, 0))


# ------------------------------------------------------------- ZeRO-3 gather
class _GatherShard(torch.autograd.Function):
    """A stage-3 leaf at use: the fp32 shard cast to the compute dtype and
    all-gathered over ``fsdp`` along ``dim``; the gradient, widened to fp32,
    reduce-scattered back onto the shard (summed over the axis)."""

    @staticmethod
    def forward(ctx, shard, dim: int, dtype):
        ctx.dim = dim
        x = shard.to(dtype)
        full = comm.all_gather(x, AXIS_FSDP, gather_dim=dim)
        return full.clone() if full is shard else full

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad.float(), AXIS_FSDP, scatter_dim=ctx.dim), None, None


class Engine:
    """Config-driven training engine over a ModelSpec: data parallel over the
    mesh's ``data`` and ``fsdp`` axes with ZeRO stages 0-3."""

    def __init__(self, model: ModelSpec | Callable[..., ModelSpec], config: Config,
                 topo: MeshTopology | None = None, training_data: Iterator | None = None,
                 seed: int | None = None, initial_params: Any = None, device=None):
        self.device = resolve_device(device)
        _refuse_unported(config)
        self.topo = topo if topo is not None else comm.init_distributed(config.mesh,
                                                                        device=self.device)
        self.config = config
        ac = config.activation_checkpointing
        if isinstance(model, ModelSpec):
            self.model_spec = model
        else:
            self.model_spec = model(remat=ac.enabled,
                                    remat_policy=resolve_remat_policy(ac.policy))
        self.training_dataloader = training_data
        self.gas = int(config.gradient_accumulation_steps)
        self.zero_stage = int(config.zero_optimization.stage)
        self.rank = self.topo.rank
        self.fsdp_index = self.topo.coord(AXIS_FSDP)
        self.fsdp_size = self.topo.size(AXIS_FSDP)
        self.data_index = self.topo.coord(AXIS_DATA)

        # ---- params: fp32 masters on the device, then this rank's shards
        seed = seed if seed is not None else config.seed
        if initial_params is not None:
            full = params_from_numpy(initial_params, torch.float32, self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            full = self.model_spec.init_fn(gen, torch.float32, self.device)
        shapes = {k: tuple(v.shape) for k, v in ser.flatten_with_keys(full)}
        axes = self.model_spec.param_logical_axes
        if axes is None:
            if self.zero_stage > 0:
                raise ValueError("ZeRO stages > 0 need the model's param_logical_axes")
            axes = _map_tree(full, lambda k, v: (None,) * v.dim())
        self.plan = plan_sharding(dict(ser.flatten_with_keys(axes)), shapes, self.topo,
                                  zero_stage=self.zero_stage,
                                  persistence_threshold=config.zero_optimization
                                  .persistence_threshold)
        self.params = _map_tree(full, self._own_block)
        del full
        self._keys = [k for k, _ in ser.flatten_with_keys(self.params)]
        self._leaves = [v for _, v in ser.flatten_with_keys(self.params)]
        self._lplan = [self.plan.leaves[k] for k in self._keys]
        for p in self._leaves:
            p.requires_grad_(True)
        # what the optimizer updates: the rank's block of each state-sharded
        # leaf (a view of the full master at stages 1-2), else the leaf
        self._update_views = [self._block_view(p, lp) if lp.state_sharded
                              and not lp.params_sharded else p
                              for p, lp in zip(self._leaves, self._lplan)]
        if self.zero_stage >= 3 and self.model_spec.shard_ctx is None:
            raise ValueError("ZeRO stage 3 needs a model spec with a shard_ctx (the gather hook)")

        # ---- optimizer (lr = 1.0; the schedule scales the updates each step)
        self._base_lr = base_lr(config.optimizer)
        self.lr_schedule = build_schedule(config.scheduler, self._base_lr)
        self.optimizer = build_optimizer(config.optimizer, learning_rate=1.0)
        self.opt_state = self.optimizer.init(self._update_views)
        self.scale_state = precision.init_loss_scale(config.fp16, self.device)
        self.lr_scheduler = LRScheduler(self.lr_schedule)

        # ---- counters and the JAX engine's two rng streams (threefry keys,
        # carried through checkpoints; the Llama loss draws from neither)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._train_rng = prng.prng_key(seed + 1)
        self._rng = prng.prng_key(seed + 2)
        self._last_metrics: dict = {}
        self._acc_grads = None  # the forward/backward protocol's (not ported)
        self._ckpt_writer = None
        self._ckpt_writer_error = None
        self._destroyed = False
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        self.tput_timer = ThroughputTimer(batch_size=config.train_batch_size or 1,
                                          steps_per_output=config.steps_per_print,
                                          synchronize=sync)
        if self.model_spec.flops_per_token and config.sequence_length:
            self.tput_timer.flops_per_sample = (
                self.model_spec.flops_per_token(config.sequence_length)
                * config.sequence_length)
        log_dist(f"engine: zero_stage={self.zero_stage} mesh {self.topo.describe()}, "
                 f"{sum(lp.state_sharded for lp in self._lplan)} of {len(self._lplan)} "
                 "leaves sharded", ranks=[0])

    # ------------------------------------------------------------- layout
    def _block_view(self, p: torch.Tensor, lp) -> torch.Tensor:
        start, stop = lp.bounds(self.fsdp_index, self.fsdp_size)
        return p.narrow(lp.dim, start, stop - start)

    def _own_block(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """The master this rank keeps of a full leaf: its block at stage 3."""
        lp = self.plan.leaves[key]
        if not lp.params_sharded or self.fsdp_size == 1:
            return full.detach()
        return self._block_view(full.detach(), lp).clone()

    def _holds(self, lp, sharded: bool) -> tuple[bool, list]:
        """(writes, box): whether this rank writes its copy of a leaf to a
        checkpoint (replica 0 of it) and the box that copy covers."""
        if sharded:
            return self.data_index == 0, lp.box(self.fsdp_index, self.fsdp_size)
        return self.rank == 0, [[0, d] for d in lp.shape]

    # ------------------------------------------------------------------ step
    def _put_gas_batch(self, batch: dict) -> dict:
        """[B_global, ...] -> this rank's [GAS, micro, ...] on the device: the
        global batch splits into GAS micro-batches, and each micro-batch's
        rows deal out to the DP ranks in (data, fsdp) order."""
        out = {}
        dp, slot = self.topo.dp_world_size, self.topo.batch_index()
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if t.shape[0] % (self.gas * dp):
                raise ValueError(
                    f"batch dim {t.shape[0]} not divisible by GAS {self.gas} x DP world "
                    f"{dp} for '{k}'")
            t = t.reshape((self.gas, t.shape[0] // self.gas) + tuple(t.shape[1:]))
            mb = t.shape[1] // dp
            out[k] = t[:, slot * mb:(slot + 1) * mb].to(self.device)
        return out

    def _rank_weights(self, batch: dict) -> list[float]:
        """Each micro-batch's weight of this rank's loss: its share of the
        micro-batch's target tokens, so the sum over ranks of the weighted
        means is the global micro-batch's mean."""
        dp, slot = self.topo.dp_world_size, self.topo.batch_index()
        out = []
        for g in range(self.gas):
            rows = {k: np.asarray(v).reshape((self.gas, -1) + np.shape(v)[1:])[g]
                    for k, v in batch.items() if k in ("input_ids", "labels")}
            mb = next(iter(rows.values())).shape[0] // dp
            total = _target_count(rows)
            mine = _target_count({k: v[slot * mb:(slot + 1) * mb] for k, v in rows.items()})
            out.append(mine / total if total else 1.0 / dp)
        return out

    def _gather_hook(self, key: str, w: torch.Tensor, stacked: bool) -> torch.Tensor:
        lp = self.plan.leaves[key]
        if not lp.params_sharded:
            return w
        return _GatherShard.apply(w, lp.dim - 1 if stacked else lp.dim,
                                  self.config.compute_dtype)

    def _compute_params(self) -> dict:
        """The params the loss sees: the compute-dtype cast of each full
        master; a stage-3 shard as it is (the gather casts it at use)."""
        dtype = self.config.compute_dtype

        def cast(key, p):
            if self.plan.leaves[key].params_sharded or not p.is_floating_point():
                return p
            return p.to(dtype)

        return _map_tree(self.params, cast)

    def _gas_grads(self, batch: dict, weights: list[float]) -> torch.Tensor:
        """Scaled, weighted loss backward per micro-batch; fp32 gradients
        accumulate in the masters' ``.grad``. Returns this rank's weighted
        micro-batch losses [GAS]."""
        scale = self.scale_state.scale
        ctx = self.model_spec.shard_ctx
        if ctx is not None:
            # installed per step, as the spec may serve another engine too
            ctx.param_gather = self._gather_hook if self.zero_stage >= 3 else None
        for p in self._leaves:
            p.grad = None
        losses = []
        for g in range(self.gas):
            mb = {k: v[g] for k, v in batch.items()}
            loss = self.model_spec.loss_fn(self._compute_params(), mb)
            (loss * (scale * weights[g])).backward()
            losses.append(loss.detach() * weights[g])
        return torch.stack(losses)

    @torch.no_grad()
    def _reduce_grads(self) -> list:
        """Sum the accumulated gradients across ranks; returns, per leaf, the
        gradient of what this rank updates."""
        grads = []
        for p, lp in zip(self._leaves, self._lplan):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if lp.params_sharded:      # reduce-scattered over fsdp in the backward
                comm.all_reduce(g, AXIS_DATA)
            elif lp.grads_sharded:
                g = comm.reduce_scatter(g, AXIS_FSDP, scatter_dim=lp.dim)
                comm.all_reduce(g, AXIS_DATA)
            else:
                comm.all_reduce(g, BATCH)
                if lp.state_sharded:
                    g = self._block_view(g, lp)
            grads.append(g)
        return grads

    @torch.no_grad()
    def _update(self, grads: list, n_micro: float, step: int) -> dict:
        cfg = self.config
        scale = self.scale_state.scale
        torch._foreach_div_(grads, scale * n_micro)
        # per-leaf squares of the norm and the non-finite flag, summed over
        # fsdp where leaves are sharded; a replicated leaf counts on fsdp
        # rank 0 only
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        bad = torch.logical_not(precision.grads_finite(grads)).float()
        if any(lp.state_sharded for lp in self._lplan):
            if self.fsdp_index:
                keep = torch.tensor([lp.state_sharded for lp in self._lplan], device=sq.device)
                sq = torch.where(keep, sq, torch.zeros_like(sq))
            red = comm.all_reduce(torch.cat([sq, bad[None]]), AXIS_FSDP)
            sq, bad = red[:-1], red[-1]
        finite = bad == 0
        gnorm = sq.sum().sqrt()
        if cfg.gradient_clipping > 0:
            torch._foreach_mul_(grads, torch.clamp(
                cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        lr = self.lr_schedule(step)
        skipped = not bool(finite)  # the step's one host sync
        if not skipped:
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                            self._update_views)
            torch._foreach_mul_(updates, lr)
            torch._foreach_add_(self._update_views, updates)
            self._gather_masters()
        self.scale_state = precision.update_loss_scale(self.scale_state, finite, cfg.fp16)
        return {"grad_norm": gnorm, "lr": lr, "loss_scale": scale, "skipped": skipped}

    def _gather_masters(self) -> None:
        """Stages 1-2: every rank's updated blocks back into the full masters."""
        for p, view, lp in zip(self._leaves, self._update_views, self._lplan):
            if lp.state_sharded and not lp.params_sharded:
                full = comm.all_gather(view, AXIS_FSDP, gather_dim=lp.dim)
                if full is not view:
                    p.copy_(full)

    def train_batch(self, batch: dict | None = None, data_iter: Iterator | None = None):
        """One optimizer step over GAS micro-batches of the global batch
        (every rank passes the same one); returns the mean micro-batch loss
        of the global batch as a 0-d tensor."""
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch needs a batch, data_iter, or training_data")
                data_iter = self.training_dataloader
            micro = [next(data_iter) for _ in range(self.gas)]
            batch = {k: np.concatenate([np.asarray(m[k]) for m in micro]) for k in micro[0]}
        dev_batch = self._put_gas_batch(batch)
        weights = self._rank_weights(batch)
        self.tput_timer.start()
        losses = comm.all_reduce(self._gas_grads(dev_batch, weights), BATCH)
        loss = losses.mean()
        metrics = self._update(self._reduce_grads(), float(self.gas), self.global_steps)
        for p in self._leaves:
            p.grad = None
        metrics["loss"] = loss
        self.tput_timer.stop(global_step=True)
        self._after_step(metrics)
        self.micro_steps += self.gas
        return loss

    def _after_step(self, metrics: dict) -> None:
        self.global_steps += 1
        self.global_samples += int(self.config.train_batch_size or 0)
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

    # ------------------------------------------------------------ checkpoint
    def _rng_state_dict(self) -> dict:
        """The two threefry keys as the JAX engine saves its keys: uint32 words."""
        return {"_rng": [int(x) for x in self._rng.tolist()],
                "_train_rng": [int(x) for x in self._train_rng.tolist()]}

    def _load_rng_state(self, state: dict | None) -> None:
        if not state:
            return
        if "_rng" in state:
            self._rng = torch.tensor([int(x) for x in state["_rng"]], dtype=torch.int64)
        if "_train_rng" in state:
            self._train_rng = torch.tensor([int(x) for x in state["_train_rng"]],
                                           dtype=torch.int64)

    def _state_fields(self):
        """(keystr prefix, field, value) of the optimizer state's fields in the
        JAX package's optax tree: ``[0].count``, ``[0].mu``, ``[1][0].nu``..."""
        prefix = self.optimizer.state_prefix
        for name, value in self.opt_state._asdict().items():
            yield f"{prefix}.{name}", name, value

    def _model_fragments(self) -> list:
        out = []
        for key, p, lp in zip(self._keys, self._leaves, self._lplan):
            writes, box = self._holds(lp, lp.params_sharded)
            out.append((key, lp.shape, np.float32, [(box, p)] if writes else []))
        return out

    def _optimizer_fragments(self) -> list:
        out = []
        for prefix, _, value in self._state_fields():
            if isinstance(value, list):
                for key, t, lp in zip(self._keys, value, self._lplan):
                    writes, box = self._holds(lp, lp.state_sharded)
                    out.append((prefix + key, lp.shape, np.float32,
                                [(box, t)] if writes else []))
            else:  # the step count: an int32 scalar, as optax keeps it
                out.append((prefix, (), np.int32,
                            [([], np.int32(value))] if self.rank == 0 else []))
        return out

    def save_checkpoint(self, save_dir: str, tag: str | None = None,
                        client_state: dict | None = None, save_latest: bool = True):
        """The JAX engine's ``save_checkpoint`` (``engine.py:2959``): a tagged
        dir with the manifest, each rank's fragment files of the model and
        optimizer trees and the ``latest`` pointer, through the two-phase
        commit (``checkpoint/engine.py``). Each rank writes only what it
        holds uniquely. With ``checkpoint.async_save`` on one process the
        host snapshot happens here and the flush runs on a writer thread."""
        from deepspeed_tpu_torch import __version__
        from deepspeed_tpu_torch.checkpoint import engine as ckpt
        from deepspeed_tpu_torch.checkpoint import sharded
        from deepspeed_tpu_torch.serving import faults

        inj = faults.get_fault_injector()
        tag = str(tag or f"global_step{self.global_steps}")
        stage_dir = ckpt.staging_dir(save_dir, tag)
        world = self.topo.world_size
        manifest = {
            "tag": tag,
            "framework_version": __version__,
            "model_name": self.model_spec.name,
            "zero_stage": self.zero_stage,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "loss_scale": float(self.scale_state.scale),
            "scale_state": {k: float(v) for k, v in self.scale_state._asdict().items()},
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "rng_state": self._rng_state_dict(),
            "dataloader_state": (self.training_dataloader.state_dict()
                                 if hasattr(self.training_dataloader, "state_dict") else None),
            "world_size": world,
            "mesh": dict(self.topo.sizes),
            "config": self.config.to_dict(),
            "client_state": client_state or {},
        }
        # snapshot to host now (the double buffer): explicit device -> host copies
        inj.fire(faults.POINT_CKPT_COLLECT)
        payloads = [("model", sharded.collect_fragments(self._model_fragments(), "model",
                                                        self.rank)),
                    ("optimizer", sharded.collect_fragments(self._optimizer_fragments(),
                                                            "optimizer", self.rank))]

        def flush():
            # phase 1 (prepare): everything goes into the staging dir
            inj.fire(faults.POINT_CKPT_FLUSH)

            def write(item):
                name, payload = item
                sharded.write_fragments(stage_dir, name, *payload, rank=self.rank,
                                        world_size=world)
                inj.fire(faults.POINT_CKPT_FLUSH, path=os.path.join(
                    stage_dir, f"{name}_shard_p{self.rank}.npz"))

            # the trees' files at once: the writes and their CRCs release the GIL
            with ThreadPoolExecutor(len(payloads)) as pool:
                list(pool.map(write, payloads))
            comm.barrier("save_checkpoint")
            if self.rank == 0:
                for name, _ in payloads:
                    sharded.finalize_index(stage_dir, name)
                # phase 2 (commit): checksum + manifest + atomic promote
                ckpt_dir = ckpt.commit_checkpoint(save_dir, tag, manifest)
                if save_latest:
                    ckpt.write_latest(save_dir, tag)
                ckpt.rotate_checkpoints(save_dir, self.config.checkpoint.keep_n_latest,
                                        protect=tag)
                log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])

        self._join_ckpt_writer()
        # async flush only off the main thread when the barrier is a no-op
        # (one process), as in the reference
        if self.config.checkpoint.async_save and world == 1:
            def flush_capturing():
                try:
                    flush()
                except BaseException as e:  # surfaced on the next join
                    self._ckpt_writer_error = e

            # non-daemon: interpreter exit waits for the flush
            self._ckpt_writer = threading.Thread(target=flush_capturing)
            self._ckpt_writer.start()
        else:
            try:
                flush()
            finally:
                # every rank leaves once rank 0 has committed (or failed)
                comm.barrier("save_checkpoint_commit")
        return os.path.join(save_dir, tag)

    def _join_ckpt_writer(self):
        """Wait for an in-flight async checkpoint flush; raises its error."""
        w = self._ckpt_writer
        if w is not None:
            w.join()
            self._ckpt_writer = None
        err = self._ckpt_writer_error
        if err is not None:
            self._ckpt_writer_error = None
            raise RuntimeError("async checkpoint flush failed") from err

    def _resolve_verified_checkpoint(self, load_dir: str, tag: str | None,
                                     verify: bool = True):
        """The JAX engine's (``engine.py:3100``): the requested (or ``latest``)
        tag if it verifies, else the newest other committed tag that does.
        Returns ``(tag, ckpt_dir, manifest)``; ``(None, None, None)`` when
        the directory holds no checkpoint; raises ``CheckpointCorruptError``
        (stage ``exhausted``) when none survives verification."""
        from deepspeed_tpu_torch.checkpoint import engine as ckpt
        from deepspeed_tpu_torch.serving import faults
        from deepspeed_tpu_torch.telemetry import TELEMETRY as tel

        requested = tag or ckpt.latest_tag(load_dir)
        candidates = list(ckpt.list_tags(load_dir))
        if requested is not None:
            if requested in candidates:
                candidates.remove(requested)
            candidates.insert(0, requested)
        if not candidates:
            return None, None, None
        inj = faults.get_fault_injector()
        fallbacks = 0
        for cand in candidates:
            cdir = os.path.join(load_dir, str(cand))
            if inj.enabled and os.path.isdir(cdir):
                # the file-mutating kinds act on the candidate's biggest file
                files = [os.path.join(cdir, f) for f in os.listdir(cdir)
                         if f != ckpt.MANIFEST]
                files = [f for f in files if os.path.isfile(f)]
                if files:
                    inj.fire(faults.POINT_CKPT_LOAD, path=max(files, key=os.path.getsize))
            v0 = time.perf_counter()
            try:
                if verify:
                    manifest = ckpt.verify_checkpoint(cdir)
                else:
                    manifest = ser.load_json(os.path.join(cdir, ckpt.MANIFEST))
            except (ckpt.CheckpointCorruptError, OSError, ValueError) as e:
                stage = getattr(e, "stage", "manifest-unreadable")
                log_dist(f"checkpoint {cand} failed verification ({stage}): {e}; "
                         "walking back", ranks=[0])
                if tel.enabled:
                    tel.counter("checkpoint_corrupt_total",
                                "checkpoint integrity failures, by verification "
                                "stage").inc(stage=stage)
                fallbacks += 1
                continue
            finally:
                if tel.enabled:
                    tel.histogram("checkpoint_verify_seconds",
                                  "wall clock of checkpoint verification").observe(
                                      time.perf_counter() - v0)
            if fallbacks and tel.enabled:
                tel.counter("checkpoint_fallback_total",
                            "loads that fell back past a corrupt checkpoint").inc(fallbacks)
            return str(cand), cdir, manifest
        if tel.enabled:
            tel.counter("checkpoint_corrupt_total",
                        "checkpoint integrity failures, by verification stage",
                        ).inc(stage="exhausted")
        raise ckpt.CheckpointCorruptError(
            f"no verifiable checkpoint under {load_dir} "
            f"(tried {len(candidates)}: {candidates[:8]})",
            stage="exhausted", tag=str(requested or ""))

    @torch.no_grad()
    def load_checkpoint(self, load_dir: str, tag: str | None = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True, verify: bool = True):
        """The JAX engine's ``load_checkpoint`` (``engine.py:3182``): verify
        (commit marker, per-file sha256, fragment coverage) before touching
        any state, walking the tag ladder past a corrupt checkpoint; then
        paste into each box this rank holds every fragment that overlaps
        it, so any world size or stage loads any other. The payload goes
        host -> this rank's device explicitly. Returns ``(ckpt_dir,
        client_state)``, or ``(None, {})`` when there is no checkpoint."""
        from deepspeed_tpu_torch.checkpoint import sharded
        from deepspeed_tpu_torch.serving import faults

        self._join_ckpt_writer()
        faults.get_fault_injector().fire(faults.POINT_CKPT_LOAD)
        tag, ckpt_dir, manifest = self._resolve_verified_checkpoint(load_dir, tag, verify)
        if tag is None:
            log_dist(f"no checkpoint found under {load_dir}", ranks=[0])
            return None, {}
        if not sharded.is_sharded(ckpt_dir, "model"):
            raise ValueError(f"{ckpt_dir}: the legacy single-file layout is not ported; "
                             "save it again with the JAX package's sharded format")

        def paste(name, entries):
            """entries: (key, shape, box, tensor) -> copy each box in place."""
            got = sharded.load_sharded([(k, s, b, np.float32) for k, s, b, _ in entries],
                                       ckpt_dir, name)
            for key, _, _, t in entries:
                t.copy_(torch.from_numpy(got[key]).to(self.device))

        paste("model", [(k, lp.shape, self._holds(lp, lp.params_sharded)[1], p)
                        for k, p, lp in zip(self._keys, self._leaves, self._lplan)])
        if load_optimizer_states and sharded.is_sharded(ckpt_dir, "optimizer"):
            fields = {}
            entries = []
            for prefix, name, value in self._state_fields():
                if isinstance(value, list):
                    entries += [(prefix + k, lp.shape, self._holds(lp, lp.state_sharded)[1], t)
                                for k, t, lp in zip(self._keys, value, self._lplan)]
                else:
                    fields[name] = int(sharded.load_sharded(
                        [(prefix, (), [], np.int64)], ckpt_dir, "optimizer")[prefix])
            paste("optimizer", entries)
            self.opt_state = self.opt_state._replace(**fields)
            scale_kw = manifest.get("scale_state")
            if scale_kw:
                self.scale_state = precision.LossScaleState(
                    scale=torch.tensor(float(scale_kw["scale"]), dtype=torch.float32,
                                       device=self.device),
                    good_steps=torch.tensor(int(scale_kw["good_steps"]), dtype=torch.int32,
                                            device=self.device),
                    hysteresis=torch.tensor(int(scale_kw["hysteresis"]), dtype=torch.int32,
                                            device=self.device),
                    dynamic=torch.tensor(bool(scale_kw["dynamic"]), device=self.device))
        self.global_steps = int(manifest["global_steps"])
        self.global_samples = int(manifest["global_samples"])
        self.micro_steps = int(manifest["micro_steps"])
        self.skipped_steps = int(manifest["skipped_steps"])
        if load_lr_scheduler_states:
            self.lr_scheduler.load_state_dict(manifest["lr_scheduler"])
        self._load_rng_state(manifest.get("rng_state"))
        dl_state = manifest.get("dataloader_state")
        if dl_state is not None and hasattr(self.training_dataloader, "load_state_dict"):
            self.training_dataloader.load_state_dict(dl_state)
        log_dist(f"loaded checkpoint {ckpt_dir} (saved at world_size="
                 f"{manifest['world_size']}, now {self.topo.world_size})", ranks=[0])
        return ckpt_dir, manifest.get("client_state", {})

    def destroy(self) -> None:
        """Join an async checkpoint flush and uninstall the stage-3 gather
        hook. Idempotent. The process group stays (``comm.destroy_distributed``
        ends it)."""
        if self._destroyed:
            return
        self._destroyed = True
        ctx = self.model_spec.shard_ctx
        if ctx is not None and ctx.param_gather == self._gather_hook:
            ctx.param_gather = None
        self._join_ckpt_writer()

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
        """The params this rank holds (at stage 3, its shards)."""
        return self.params


def initialize(model: ModelSpec | Callable[..., ModelSpec] | None = None,
               config: Config | dict | str | None = None,
               training_data: Iterator | None = None, seed: int | None = None,
               initial_params: Any = None, device=None):
    """Build the engine (counterpart of ``deepspeed_tpu.initialize``).

    ``model``: a ``ModelSpec``, or a builder called as
    ``model(remat=..., remat_policy=...)`` with the config's activation
    checkpointing. ``initial_params``: a nested dict of numpy arrays (fp32
    masters are made from it). ``device``: ``None`` is ``cuda:0`` (or
    ``cuda:$LOCAL_RANK``) and raises without a card; pass ``"cpu"`` for the
    plain path on the CPU.

    The process joins the process group the environment describes
    (``comm.init_distributed``: NCCL on the card, gloo on the CPU; world 1
    with none), the config's mesh is laid over it (a mesh that does not make
    up the world raises ``ValueError``) and the batch triangle resolves for
    its DP world.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    if model is None:
        raise ValueError("initialize() requires a model (ModelSpec or builder callable)")
    if device is None and os.environ.get("LOCAL_RANK") is not None:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    cfg = load_config(config)
    _refuse_unported(cfg)
    topo = comm.init_distributed(cfg.mesh, device=dev)
    cfg.resolve_batch_sizes(topo.dp_world_size)
    comm.configure(cfg.comms_logger)
    engine = Engine(model, cfg, topo=topo, training_data=training_data, seed=seed,
                    initial_params=initial_params, device=dev)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
