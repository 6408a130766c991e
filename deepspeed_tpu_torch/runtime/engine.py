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

``backward(batch)`` runs one micro-batch of the same loop into the same
gradient buffers (the masters' ``.grad``, laid out as the ZeRO plan lays
the masters) and ``step()`` runs the same ``_update`` at the accumulation
boundary, so ``backward`` x GAS + ``step`` is ``train_batch`` bit for bit;
``forward`` is the eval loss.

The sentinel (``runtime/sentinel.py``, ``config.sentinel``) folds its
anomaly verdict into ``_update``: the step's one host sync reads the
verdict instead of the finite flag, and an anomalous step skips like an
overflow. Its host side quarantines batches, rolls back to a checkpoint
and replays, halts with forensics, fences a step under the dispatch
watchdog and beats the heartbeat. The fault points ``train.grads``,
``data.batch`` and ``train.dispatch`` fire in ``train_batch``.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) are the JAX
package's format and protocol (``checkpoint/``): either package loads the
other's, at any world size and stage, and a legacy single-file tag
(``model.npz``) loads too. Features this slice has not ported raise
``NotImplementedError`` naming their ROADMAP item; the FLOPs profiler and
telemetry's training spans are not ported.
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
from deepspeed_tpu_torch.runtime import sentinel as sentinel_mod
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
        self._acc_count = 0  # micro-batches backward() has accumulated
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
        self._init_sentinel()
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
        """Each micro-batch's weight of this rank's loss (``_micro_weight``)."""
        return [self._micro_weight({k: np.asarray(v).reshape((self.gas, -1) + np.shape(v)[1:])[g]
                                    for k, v in batch.items() if k in ("input_ids", "labels")})
                for g in range(self.gas)]

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

    def _install_gather(self) -> None:
        ctx = self.model_spec.shard_ctx
        if ctx is not None:
            # installed per step, as the spec may serve another engine too
            ctx.param_gather = self._gather_hook if self.zero_stage >= 3 else None

    def _micro_grads(self, mb: dict, weight: float) -> torch.Tensor:
        """One micro-batch's scaled, weighted loss backward into the masters'
        ``.grad`` (fp32, summed over micro-batches); returns this rank's
        weighted loss. A ``__loss_mult__`` row (the fault directives)
        multiplies the loss inside the tape, so the gradients blow up too."""
        mb = dict(mb)
        mult = mb.pop("__loss_mult__", None)
        loss = self.model_spec.loss_fn(self._compute_params(), mb)
        if mult is not None:
            loss = loss * mult.reshape(-1)[0]
        (loss * (self.scale_state.scale * weight)).backward()
        return loss.detach() * weight

    def _gas_grads(self, batch: dict, weights: list[float]) -> torch.Tensor:
        """``_micro_grads`` over the GAS micro-batches; returns this rank's
        weighted micro-batch losses [GAS]."""
        self._install_gather()
        for p in self._leaves:
            p.grad = None
        return torch.stack([self._micro_grads({k: v[g] for k, v in batch.items()}, weights[g])
                            for g in range(self.gas)])

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
    def _update(self, grads: list, n_micro: float, step: int, loss=None) -> dict:
        """The optimizer step's tail (``engine.py:1000``). With the sentinel on
        and the step's ``loss`` given, the anomaly verdict gates the update
        in place of the finite flag, and the one host read takes the flag,
        the verdict, its reason and streak together."""
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
        if self._lr_scale != 1.0:  # the sentinel's third-strike backoff, in fp32
            lr = float(np.float32(lr) * np.float32(self._lr_scale))
        metrics = {"grad_norm": gnorm, "lr": lr, "loss_scale": scale}
        if self._sent_state is not None and loss is not None:
            self._sent_state, anomaly, reason, streak = sentinel_mod.verdict(
                self._sent_state, loss, gnorm, finite, cfg.sentinel)
            # the step's one host sync
            ok, anomalous, reason, streak = torch.stack(
                [finite.int(), anomaly.int(), reason, streak]).tolist()
            finite_host, apply = bool(ok), not anomalous
            metrics.update(anomalous=bool(anomalous), anomaly_reason=reason,
                           skip_streak=streak)
        else:
            finite_host = bool(finite)  # the step's one host sync
            apply = finite_host
        if apply:
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                            self._update_views)
            torch._foreach_mul_(updates, lr)
            torch._foreach_add_(self._update_views, updates)
            self._gather_masters()
        # the scaler keys on the finite flag: fp16 is its business, not the sentinel's
        self.scale_state = precision.update_loss_scale(self.scale_state, finite, cfg.fp16)
        metrics["skipped"] = not finite_host
        return metrics

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
        of the global batch as a 0-d tensor. With the sentinel on, an
        anomalous step may roll the engine back to a checkpoint (then
        ``global_steps`` goes back; a wedged step returns NaN)."""
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch needs a batch, data_iter, or training_data")
                data_iter = self.training_dataloader
            micro = [next(data_iter) for _ in range(self.gas)]
            batch = {k: np.concatenate([np.asarray(m[k]) for m in micro]) for k in micro[0]}
        inj = self._fault_injector
        if self._sentinel is not None or inj.enabled:
            batch = self._sentinel_pre_step(batch)
        dev_batch = self._put_gas_batch(batch)
        weights = self._rank_weights(batch)
        self.tput_timer.start()
        losses = comm.all_reduce(self._gas_grads(dev_batch, weights), BATCH)
        loss = losses.mean()
        metrics = self._update(self._reduce_grads(), float(self.gas), self.global_steps,
                               loss=loss)
        for p in self._leaves:
            p.grad = None
        metrics["loss"] = loss
        if self._sentinel is not None and self._watchdog_timeout > 0:
            # fence this step under the deadline: the seam, then the device
            try:
                sentinel_mod.watched_call(
                    lambda: (inj.fire(self._faults.POINT_TRAIN_DISPATCH), self._fence()),
                    self._watchdog_timeout)
            except sentinel_mod.TrainingWedgeError as e:
                return self._handle_wedge(e)
        elif inj.enabled:
            inj.fire(self._faults.POINT_TRAIN_DISPATCH)
        self.tput_timer.stop(global_step=True)
        self._after_step(metrics)
        self.micro_steps += self.gas
        if self._sentinel is not None:
            # after the counters: a rollback here restores them from the manifest
            self._sentinel_post_step()
        return loss

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------ forward / backward / step
    def _put_microbatch(self, batch: dict) -> dict:
        """One global micro-batch [mb * dp, ...] -> this rank's rows on the device."""
        dp, slot = self.topo.dp_world_size, self.topo.batch_index()
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if t.shape[0] % dp:
                raise ValueError(f"batch dim {t.shape[0]} not divisible by DP world {dp} "
                                 f"for '{k}'")
            mb = t.shape[0] // dp
            out[k] = t[slot * mb:(slot + 1) * mb].to(self.device)
        return out

    def _micro_weight(self, batch: dict) -> float:
        """This rank's share of one global micro-batch's target tokens: the
        sum over ranks of the weighted means is the micro-batch's mean."""
        dp, slot = self.topo.dp_world_size, self.topo.batch_index()
        rows = {k: np.asarray(v) for k, v in batch.items() if k in ("input_ids", "labels")}
        mb = next(iter(rows.values())).shape[0] // dp
        total = _target_count(rows)
        mine = _target_count({k: v[slot * mb:(slot + 1) * mb] for k, v in rows.items()})
        return mine / total if total else 1.0 / dp

    def _next_rng(self) -> torch.Tensor:
        """``jax.random.split`` of the engine's key (partitionable threefry:
        the halves are ``fold_in(key, 0)`` and ``fold_in(key, 1)``)."""
        self._rng, sub = prng.fold_in(self._rng, 0), prng.fold_in(self._rng, 1)
        return sub

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """The eval loss of one global micro-batch, no gradients
        (``engine.py:2361``): each rank's loss weighted by its share of the
        target tokens, summed over ranks."""
        self._next_rng()
        self._install_gather()
        loss = self.model_spec.loss_fn(self._compute_params(), self._put_microbatch(batch))
        return comm.all_reduce(loss.float() * self._micro_weight(batch), BATCH)

    eval_batch = forward

    def backward(self, batch: dict) -> torch.Tensor:
        """Accumulate the gradients of one global micro-batch
        (``engine.py:2370``) into the masters' ``.grad``, where ``train_batch``
        accumulates them; ``step()`` consumes them. Returns the micro-batch's
        loss (unscaled)."""
        z, cfg = self.config.zero_optimization, self.config
        if (z.offload_optimizer.device == "nvme" or z.quantized_gradients or z.zenflow.enabled
                or z.grad_overlap.enabled or cfg.progressive_layer_drop.enabled
                or bool(cfg.compression_training)):
            raise NotImplementedError(
                "the fwd/bwd/step parity path does not support NVMe-offloaded "
                "optimizer state, quantized gradient reduction, zenflow, "
                "grad_overlap, progressive layer drop, or compression "
                "training; use train_batch()")
        if self._acc_count == 0:
            self._install_gather()
            for p in self._leaves:
                p.grad = None
        self._next_rng()
        loss = self._micro_grads(self._put_microbatch(batch), self._micro_weight(batch))
        self._acc_count += 1
        self.micro_steps += 1
        return comm.all_reduce(loss, BATCH)

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._acc_count >= self.gas

    def step(self) -> None:
        """At the accumulation boundary, the optimizer step over the
        accumulated gradients (``engine.py:2434``): ``train_batch``'s
        ``_update`` and ``_after_step``. Before it, nothing."""
        if not self.is_gradient_accumulation_boundary():
            return
        metrics = self._update(self._reduce_grads(), float(self._acc_count), self.global_steps)
        for p in self._leaves:
            p.grad = None
        self._acc_count = 0
        self._after_step(metrics)

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
            loss = metrics.get("loss")
            loss_str = f"loss={float(loss):.4f} " if loss is not None else ""
            skip = f"skipped={self.skipped_steps} " if self.skipped_steps else ""
            log_dist(f"step={self.global_steps} {loss_str}"
                     f"lr={metrics['lr']:.3e} grad_norm={float(metrics['grad_norm']):.3f} "
                     f"{skip}", ranks=[0])
        if self._heartbeat is not None:
            # here, on the training thread at the step boundary, never from a
            # helper thread: a wedged step must stop the beat
            self._heartbeat.beat(self.global_steps)

    # ------------------------------------------------------------- sentinel
    def _init_sentinel(self) -> None:
        """Self-healing training (``engine.py:796``): off by default."""
        from deepspeed_tpu_torch.serving import faults

        cfg = self.config.sentinel
        self._faults = faults
        self._fault_injector = faults.get_fault_injector()
        self._sentinel = None
        self._sent_state = None
        self._heartbeat = None
        self._lr_scale = 1.0
        self._watchdog_timeout = 0.0
        self._last_batch_fps: list[str] = []
        self._last_save_dir: str | None = None
        self.train_rollbacks = 0
        if not cfg.enabled:
            return
        self._sentinel = sentinel_mod.SentinelPolicy(cfg)
        self._sent_state = sentinel_mod.init_state(cfg, self.device)
        self._watchdog_timeout = float(cfg.dispatch_timeout_s)
        if cfg.state_dir:
            rank = int(os.environ.get("RANK", self.rank))
            self._heartbeat = sentinel_mod.Heartbeat(cfg.state_dir, rank=rank,
                                                     interval_s=cfg.heartbeat_interval_s)
        self._apply_quarantine_to_loader()
        log_dist(f"sentinel: loss EMA+{cfg.loss_sigma_k:g}sigma / grad q{cfg.grad_quantile:g}"
                 f"x{cfg.grad_quantile_mult:g} gates, window {cfg.window_steps} steps, third "
                 f"strike -> {cfg.on_third_strike}"
                 + (f", dispatch watchdog {self._watchdog_timeout:g}s"
                    if self._watchdog_timeout else "")
                 + (f", {len(self._sentinel.quarantined)} quarantined fingerprint(s) restored"
                    if self._sentinel.quarantined else ""), ranks=[0])

    def _sentinel_pre_step(self, batch: dict) -> dict:
        """Fingerprint the step's micro-batches (before anything is added to
        the batch) and consult the ``train.grads`` / ``data.batch`` seams; a
        directive rides a ``__loss_mult__`` row that ``_micro_grads``
        multiplies into the loss."""
        gas = self.gas
        lead = int(np.asarray(next(iter(batch.values()))).shape[0])
        if lead % gas == 0:
            # as the quarantining loaders see the micro-batches: the concatenation
            # here and the split there give the same arrays
            self._last_batch_fps = [
                sentinel_mod.batch_fingerprint(
                    {k: np.asarray(v).reshape((gas, lead // gas) + np.shape(v)[1:])[i]
                     for k, v in batch.items()})
                for i in range(gas)]
        inj = self._fault_injector
        if not inj.enabled:
            return batch
        directive = inj.fire(self._faults.POINT_TRAIN_GRADS)
        if directive is None:
            for fp in self._last_batch_fps:
                directive = inj.fire(self._faults.POINT_DATA_BATCH, request_id=fp)
                if directive is not None:
                    break
        if directive is None:
            return batch
        mult = float("nan") if directive == "nan-grads" else sentinel_mod.SPIKE_LOSS_MULT
        log_dist(f"fault injection: {directive} directive at step {self.global_steps} "
                 f"(loss x {mult})", ranks=[0])
        return {**batch, "__loss_mult__": np.full((lead,), mult, np.float32)}

    def _sentinel_post_step(self) -> None:
        """Walk the ladder on this step's settled verdict (already on the host:
        ``_update`` read it in the step's one sync)."""
        pol, cfg, m = self._sentinel, self.config.sentinel, self._last_metrics
        if not m.get("anomalous"):
            pol.tick()
            return
        reason, streak = int(m["anomaly_reason"]), int(m["skip_streak"])
        if (self.config.fp16.enabled and reason == sentinel_mod.REASON_NONFINITE
                and streak < cfg.max_consecutive_skips):
            # a routine fp16 overflow is the loss scaler's business
            pol.tick()
            return
        names = sentinel_mod.reason_names(reason)
        fps = list(self._last_batch_fps)
        from deepspeed_tpu_torch.telemetry import TELEMETRY as tel

        if tel.enabled:
            ctr = tel.counter("sentinel_anomalies_total",
                              "anomalous training steps flagged by the sentinel")
            for n in names:
                ctr.inc(reason=n)
        tag = None
        ckpt_dir = self._sentinel_ckpt_dir()
        if ckpt_dir:
            from deepspeed_tpu_torch.checkpoint.engine import latest_tag

            tag = latest_tag(ckpt_dir)
        action = pol.observe(reason, fps, latest_tag=tag)
        self._apply_quarantine_to_loader()
        ctx = {"global_steps": self.global_steps, "micro_steps": self.micro_steps,
               "reason": names, "skip_streak": streak, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "fingerprints": fps,
               "quarantined": list(pol.quarantined),
               "strikes_in_window": pol.strikes_in_window, "action": action}
        log_dist(f"sentinel: anomalous step {self.global_steps - 1} ({'+'.join(names)}; "
                 f"update skipped) -> {action}", ranks=[0])
        path = sentinel_mod.write_forensics(cfg.report_dir, action.replace("-", "_"), ctx)
        if action == "rollback":
            self._sentinel_rollback(ctx)
        elif action == "reduce-lr":
            self._lr_scale *= float(cfg.lr_backoff)
            pol.lr_backoffs += 1
            if tel.enabled:
                tel.counter("sentinel_lr_backoffs_total",
                            "sentinel third-strike LR reductions").inc()
            log_dist(f"sentinel: third strike -> lr backoff x{cfg.lr_backoff:g} "
                     f"(cumulative scale {self._lr_scale:g})", ranks=[0])
        elif action == "halt":
            raise sentinel_mod.DivergenceHaltError(
                f"sentinel: third strike at step {self.global_steps - 1} "
                f"({'+'.join(names)}) — halting per sentinel.on_third_strike='halt'",
                report=path)

    def _sentinel_ckpt_dir(self) -> str | None:
        return self.config.sentinel.checkpoint_dir or self._last_save_dir

    def _apply_quarantine_to_loader(self) -> None:
        dl, pol = self.training_dataloader, self._sentinel
        if pol is not None and pol.quarantined and dl is not None and hasattr(dl, "quarantine"):
            dl.quarantine(pol.quarantined)

    def _sentinel_rollback(self, ctx: dict) -> None:
        """Restore the tag pinned at strike 1 and replay; the loader skips the
        quarantined batches, so the stitched run is a clean run that never
        saw them."""
        pol, cfg = self._sentinel, self.config.sentinel
        ckpt_dir, tag = self._sentinel_ckpt_dir(), pol.rollback_tag
        if not ckpt_dir or tag is None:
            path = sentinel_mod.write_forensics(cfg.report_dir, "halt", {
                **ctx, "error": "rollback requested but no checkpoint is available"})
            raise sentinel_mod.DivergenceHaltError(
                "sentinel: rollback requested but no verified checkpoint is available "
                "(set sentinel.checkpoint_dir or save one first)", report=path)
        log_dist(f"sentinel: rolling back to checkpoint {tag!r}; replaying with quarantined "
                 "batches skipped", ranks=[0])
        t0 = time.perf_counter()
        self.load_checkpoint(ckpt_dir, tag=tag)
        self.last_rollback_s = time.perf_counter() - t0
        pol.rollbacks += 1
        self.train_rollbacks += 1
        from deepspeed_tpu_torch.telemetry import TELEMETRY as tel

        if tel.enabled:
            tel.counter("train_rollbacks_total", "sentinel rollback-and-replay restores").inc()

    def _handle_wedge(self, err) -> float:
        """A dispatch fence past the deadline: forensics, then a rollback, or
        a halt when the window's wedge budget or the checkpoints run out."""
        pol, cfg = self._sentinel, self.config.sentinel
        from deepspeed_tpu_torch.telemetry import TELEMETRY as tel

        if tel.enabled:
            tel.counter("train_wedge_timeouts_total",
                        "training dispatch fences past the watchdog deadline").inc()
        action = pol.observe_wedge()
        ckpt_dir, tag = self._sentinel_ckpt_dir(), pol.rollback_tag
        if ckpt_dir and tag is None:
            from deepspeed_tpu_torch.checkpoint.engine import latest_tag

            tag = latest_tag(ckpt_dir)
        ctx = {"global_steps": self.global_steps, "micro_steps": self.micro_steps,
               "reason": ["wedge"], "timeout_s": self._watchdog_timeout, "error": str(err),
               "action": action}
        path = sentinel_mod.write_forensics(cfg.report_dir, "wedge", ctx)
        log_dist(f"sentinel: {err} -> {action}", ranks=[0])
        if action == "rollback" and ckpt_dir and tag is not None:
            pol.rollback_tag = tag
            self._sentinel_rollback(ctx)
            return float("nan")  # the wedged step's loss is unknowable
        raise sentinel_mod.DivergenceHaltError(
            f"sentinel: training dispatch wedged past {self._watchdog_timeout:g}s and no "
            f"rollback is available (action {action!r})", report=path) from err

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
        self._last_save_dir = save_dir  # the sentinel's rollback target by default
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
        if sharded.is_sharded(ckpt_dir, "model"):
            self._load_sharded_state(ckpt_dir, manifest, load_optimizer_states)
        else:
            self._load_legacy_state(ckpt_dir, load_optimizer_states)
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
        if self._sentinel is not None:
            # the rolling stats describe a trajectory position that no longer
            # exists: restart them, and re-skip the quarantined batches on the
            # freshly positioned loader (the manifest predates the quarantine)
            self._sent_state = sentinel_mod.init_state(self.config.sentinel, self.device)
            self._apply_quarantine_to_loader()
        self._acc_count = 0
        log_dist(f"loaded checkpoint {ckpt_dir} (saved at world_size="
                 f"{manifest['world_size']}, now {self.topo.world_size})", ranks=[0])
        return ckpt_dir, manifest.get("client_state", {})

    def _opt_entries(self) -> tuple[list, list]:
        """``(entries, scalars)`` of the optimizer state: ``(key, shape, box,
        tensor)`` of each leaf this rank holds, and the scalar fields'
        ``(key, name)``."""
        entries, scalars = [], []
        for prefix, name, value in self._state_fields():
            if isinstance(value, list):
                entries += [(prefix + k, lp.shape, self._holds(lp, lp.state_sharded)[1], t)
                            for k, t, lp in zip(self._keys, value, self._lplan)]
            else:
                scalars.append((prefix, name))
        return entries, scalars

    def _model_entries(self) -> list:
        return [(k, lp.shape, self._holds(lp, lp.params_sharded)[1], p)
                for k, p, lp in zip(self._keys, self._leaves, self._lplan)]

    def _load_sharded_state(self, ckpt_dir: str, manifest: dict, load_optimizer: bool) -> None:
        from deepspeed_tpu_torch.checkpoint import sharded

        def paste(name, entries):
            """entries: (key, shape, box, tensor) -> copy each box in place."""
            got = sharded.load_sharded([(k, s, b, np.float32) for k, s, b, _ in entries],
                                       ckpt_dir, name)
            for key, _, _, t in entries:
                t.copy_(torch.from_numpy(got[key]).to(self.device))

        paste("model", self._model_entries())
        if load_optimizer and sharded.is_sharded(ckpt_dir, "optimizer"):
            entries, scalars = self._opt_entries()
            paste("optimizer", entries)
            self.opt_state = self.opt_state._replace(**{
                name: int(sharded.load_sharded([(key, (), [], np.int64)], ckpt_dir,
                                               "optimizer")[key])
                for key, name in scalars})
            scale_kw = manifest.get("scale_state")
            if scale_kw:
                self._set_scale_state({k: scale_kw[k] for k in
                                       ("scale", "good_steps", "hysteresis", "dynamic")})

    def _load_legacy_state(self, ckpt_dir: str, load_optimizer: bool) -> None:
        """The legacy single-file layout (``engine.py:3242-3275``): ``model.npz``
        and ``optimizer.npz`` of full arrays by keystr, the loss scale's
        fields under ``__scale__``; each rank pastes its boxes."""
        names = ["model"] + (["optimizer"] if load_optimizer else [])
        arrays = {n: ser.load_arrays(os.path.join(ckpt_dir, f"{n}.npz")) for n in names
                  if os.path.exists(os.path.join(ckpt_dir, f"{n}.npz"))}

        def paste(got, entries):
            for key, shape, box, t in entries:
                if key not in got:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = got[key]
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != expected "
                                     f"{tuple(shape)}")
                sl = tuple(slice(s, e) for s, e in box)
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr[sl], np.float32))
                        .to(self.device))

        paste(arrays["model"], self._model_entries())
        opt = arrays.get("optimizer")
        if opt is not None:
            entries, scalars = self._opt_entries()
            paste(opt, entries)
            self.opt_state = self.opt_state._replace(**{name: int(opt[key])
                                                        for key, name in scalars})
            scale_kw = {k[len("__scale__"):]: v for k, v in opt.items()
                        if k.startswith("__scale__")}
            if scale_kw:
                self._set_scale_state(scale_kw)

    def _set_scale_state(self, kw: dict) -> None:
        dev = self.device
        self.scale_state = precision.LossScaleState(
            scale=torch.tensor(float(kw["scale"]), dtype=torch.float32, device=dev),
            good_steps=torch.tensor(int(kw["good_steps"]), dtype=torch.int32, device=dev),
            hysteresis=torch.tensor(int(kw["hysteresis"]), dtype=torch.int32, device=dev),
            dynamic=torch.tensor(bool(kw["dynamic"]), device=dev))

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
