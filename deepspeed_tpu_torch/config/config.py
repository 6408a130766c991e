"""The framework config tree (a copy of ``deepspeed_tpu/config/config.py``).

The JSON grammar is the JAX package's, field for field: every section, the
``"auto"`` fields, the deprecation aliases and the batch triangle parse the
same here; only ``Config.compute_dtype`` names a torch dtype. The grammar
accepts every field, including those of features the port has not yet
brought over: the training engine (``runtime/engine.py``) refuses those
with ``NotImplementedError`` naming their ROADMAP item.

Role parity with the reference's ``runtime/config.py`` (``DeepSpeedConfig``) and its
per-feature sub-configs (``runtime/zero/config.py``, ``precision_config.py``,
``zenflow_config.py``, monitor/comms/flops configs). Same shape: one JSON/dict in,
a validated typed tree out, with the batch-size triangle
(``train_batch_size = micro_batch_size * gradient_accumulation_steps * dp_world``)
resolved centrally.

TPU-first differences: a ``mesh`` section declares named parallelism axes
(data/fsdp/tensor/sequence/expert/pipeline) instead of implicit process groups;
precision is bf16-default; offload targets are host DRAM / NVMe on the TPU-VM.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional, Union

from deepspeed_tpu_torch.config.base import AUTO, ConfigBase, ConfigError, is_auto


# Canonical spellings of the compressed-optimizer family — THE single list
# (ops/optimizers.py dispatch, the engine's two-phase wire switch, and this
# config validation all consume it; a spelling added here is recognized
# everywhere at once).
ONEBIT_ADAM_NAMES = ("onebit_adam", "onebitadam", "1bit-adam", "1bit_adam")
ONEBIT_LAMB_NAMES = ("onebit_lamb", "onebitlamb", "1bit-lamb", "1bit_lamb")
ZERO_ONE_ADAM_NAMES = ("zero_one_adam", "zerooneadam", "01adam", "zoadam")


def is_onebit_family(name: str) -> bool:
    """True for every optimizer whose reference counterpart compresses its
    gradient wire after warmup (1-bit Adam/LAMB, 0/1 Adam)."""
    n = name.lower().replace("-", "_")
    return n in tuple(s.replace("-", "_") for s in
                      ONEBIT_ADAM_NAMES + ONEBIT_LAMB_NAMES
                      + ZERO_ONE_ADAM_NAMES)


@dataclass
class OptimizerConfig(ConfigBase):
    type: str = "adamw"  # adamw | adam | sgd | lion | lamb | adagrad
    params: dict = field(default_factory=dict)

    _SUPPORTED: ClassVar[set] = {
        "adam", "adamw", "sgd", "lion", "lamb", "adagrad", "muon",
        *ONEBIT_ADAM_NAMES, *ONEBIT_LAMB_NAMES, *ZERO_ONE_ADAM_NAMES,
    }

    def _validate(self, path: str = "") -> None:
        if self.type.lower() not in self._SUPPORTED:
            raise ConfigError(f"{path}type: unsupported optimizer '{self.type}' (choose from {sorted(self._SUPPORTED)})")


@dataclass
class SchedulerConfig(ConfigBase):
    """Reference LR schedules: WarmupLR / WarmupDecayLR / WarmupCosineLR / OneCycle / LRRangeTest
    (``runtime/lr_schedules.py``)."""

    type: str = "WarmupLR"
    params: dict = field(default_factory=dict)


@dataclass
class FP16Config(ConfigBase):
    """fp16 + dynamic loss scaling (reference: ``runtime/fp16/loss_scaler.py:187``)."""

    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    _auto_fields: ClassVar[set] = {"enabled"}


@dataclass
class BF16Config(ConfigBase):
    # None = "auto": on unless fp16 is explicitly enabled (TPU-first default).
    enabled: Optional[bool] = None
    # Keep a float32 master copy of params and do the optimizer step in fp32
    # (reference: runtime/bf16_optimizer.py:37).
    master_weights: bool = True

    _auto_fields: ClassVar[set] = {"enabled"}


@dataclass
class OffloadConfig(ConfigBase):
    """Offload tier for optimizer state / params (reference: zero offload + swap_tensor)."""

    device: str = "none"  # none | cpu | nvme
    nvme_path: str = "/tmp/dstpu_nvme"
    pin_memory: bool = True
    buffer_count: int = 4
    # SuperOffload (reference offload_config.py:96 + superoffload_stage3.py:27).
    # device=cpu: keep the hottest sub-groups' optimizer state HBM-resident
    # (hbm_resident_fraction of groups) instead of streaming them; device=nvme:
    # dispatch group updates speculatively — the overflow guard rides along as
    # a device predicate, replacing the reference's CPU-Adam rollback.
    super_offload: bool = False
    hbm_resident_fraction: float = 0.25
    # reference knob: CPU cores for the CPU-Adam worker pool. Accepted for
    # config compatibility; the update math runs on-device here.
    cpuadam_cores_perc: float = 0.8

    def _validate(self, path: str = "") -> None:
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"{path}device: must be none|cpu|nvme, got {self.device!r}")
        if not (0.0 <= self.hbm_resident_fraction <= 1.0):
            raise ConfigError(
                f"{path}hbm_resident_fraction: must be in [0, 1], got "
                f"{self.hbm_resident_fraction}")

    @classmethod
    def from_dict(cls, data, path: str = ""):
        data = dict(data or {})
        if "zenflow_topk_ratio" in data:
            from deepspeed_tpu_torch.utils.logging import logger

            logger.warning(
                f"Config field '{path}zenflow_topk_ratio' moved: set "
                "'zero_optimization.zenflow: {enabled: true, topk_ratio: ...}'."
            )
            data.pop("zenflow_topk_ratio")
        return super().from_dict(data, path=path)


@dataclass
class ZenFlowConfig(ConfigBase):
    """ZenFlow importance-aware split update (reference
    ``runtime/zenflow/zenflow_config.py``): hot top-k blocks update on device
    every step; the cold remainder accumulates and applies in one deferred
    windowed update per ``update_interval`` steps. Requires
    ``offload_optimizer.device: cpu``. See ``runtime/zenflow.py``."""

    enabled: bool = False
    topk_ratio: float = 0.05
    update_interval: int = 4
    select_strategy: str = "step"  # step | auto | epoch (all step-based here)
    select_interval: int = 100
    full_warm_up_rounds: int = 1
    # reference knob: run the cold update on a worker process. Accepted for
    # config compatibility; JAX async dispatch already overlaps the deferred
    # cold program with subsequent steps.
    overlap_step: bool = True
    # hot-selection granularity in elements (lane-aligned gathers)
    block: int = 256

    def _validate(self, path: str = "") -> None:
        if not (0.0 < self.topk_ratio <= 1.0):
            raise ConfigError(f"{path}topk_ratio: must be in (0, 1], got {self.topk_ratio}")
        if self.update_interval < 1:
            raise ConfigError(f"{path}update_interval: must be >= 1")
        if self.select_interval < 1:
            raise ConfigError(f"{path}select_interval: must be >= 1")
        if self.full_warm_up_rounds < 1:
            raise ConfigError(
                f"{path}full_warm_up_rounds: must be >= 1 (the first selection "
                "needs one dense step's gradients)")
        if self.select_strategy not in ("step", "auto", "epoch"):
            raise ConfigError(f"{path}select_strategy: must be step|auto|epoch")
        if self.block < 1:
            raise ConfigError(f"{path}block: must be >= 1")

    @classmethod
    def from_dict(cls, data, path: str = ""):
        data = dict(data or {})
        # Reference semantics (zero/config.py:172 Optional[ZenFlowConfig]):
        # the PRESENCE of a zenflow block under zero_optimization enables it
        # (including an empty all-defaults block). With enabled left unset,
        # presence therefore means "on" — otherwise a ported reference config
        # trains dense with no warning. (This classmethod only runs when the
        # user actually wrote a zenflow key; the default_factory path never
        # comes through here.)
        if "enabled" not in data:
            data["enabled"] = True
        # Reference ZenFlowConfig defaults these to "auto"; configure_zenflow
        # resolves them to step-based values. Accept the spelling and map it
        # to this build's step-based defaults.
        if is_auto(data.get("select_interval")):
            data["select_interval"] = cls.select_interval
        if is_auto(data.get("update_interval")):
            data["update_interval"] = cls.update_interval
        return super().from_dict(data, path=path)


@dataclass
class GradOverlapConfig(ConfigBase):
    """Overlap-first data-parallel backward (parallel/grad_overlap.py).

    Partitions the grad tree into size-targeted buckets and reduces each as
    an async ppermute ring inside a shard_map manual region, so later layers'
    backward compute fills earlier buckets' transfer windows (docs/
    TP_OVERLAP.md, "grad-sync overlap"). Off by default; when off the engine
    builds exactly the fused baseline program.
    """

    enabled: bool = False
    # target bucket payload in bytes (fp32 accumulation); rounded DOWN to a
    # power of two at planning time
    bucket_bytes: int = 4 * 2**20
    # ZeRO-1-without-fsdp-axis: each data rank updates only its reduce-
    # scattered grad shard, then all-gathers updated params — optimizer FLOPs
    # and state-touch bytes drop by 1/dp
    sharded_update: bool = True
    # exactness kill switch: route the step through the fused baseline
    # program (bit-identical by construction) while keeping the config
    # surface — for A/B-ing the documented fp-reorder of the ring reduction
    exact: bool = False

    def _validate(self, path: str = "") -> None:
        if self.bucket_bytes < 256:
            raise ConfigError(
                f"{path}bucket_bytes: must be >= 256, got {self.bucket_bytes}")


@dataclass
class ZeroConfig(ConfigBase):
    """ZeRO stages as sharding policy (reference: ``runtime/zero/config.py:401``).

    On TPU the stages are declarative sharding choices over the ``fsdp`` mesh axis:
      0: replicate params/grads/opt-state (pure DP, psum grads)
      1: shard optimizer state
      2: shard optimizer state + gradients (reduce_scatter at the GAS boundary)
      3: shard parameters too (allgather-on-use, per scanned layer block)
    """

    stage: int = 0
    offload_optimizer: OffloadConfig = field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = field(default_factory=OffloadConfig)
    # stage-3 style knobs
    persistence_threshold: int = 0  # params smaller than this stay replicated
    # offload windowing: elements per optimizer sub-group (reference stage3
    # sub_group_size); one group's state is in HBM at a time
    sub_group_size: int = 100_000_000
    # ZeRO++ qgZ: quantized gradient reduction with error feedback
    # (comm/quantized_collectives.py; requires a pure data-parallel mesh)
    quantized_gradients: bool = False
    # wire width for the quantized reduction: 8 (qgZ int8), 4 (nibble-packed)
    # or 1 (sign+scale — the 1-bit Adam/LAMB compressed wire, reference
    # runtime/comm/nccl.py compressed_allreduce). With a 1-bit-family
    # optimizer the engine runs a DENSE wire during the optimizer's warmup
    # (freeze_step) and switches to this width after, matching the reference
    # two-phase protocol.
    quantized_gradients_bits: int = 8
    # ZeRO++ qwZ: int8 blockwise-quantized weight all-gather on the stage-3
    # path (parallel/qwz.py; reference partition_parameters.py:1446 quantized
    # all_gather_coalesced). Halves the dominant stage-3 collective.
    quantized_weights: bool = False
    qwz_block: int = 128
    # ZenFlow split update over the offloaded tier (runtime/zenflow.py)
    zenflow: ZenFlowConfig = field(default_factory=ZenFlowConfig)
    # ZeRO++ hpZ: optimizer+gradient state shards over the FULL world
    # (data x fsdp) while live stage-3 params shard over fsdp only, so param
    # gathers ride the fast intra-group axis (reference
    # partition_parameters.py:1806 secondary partition). Map the reference
    # layout onto the mesh: fsdp = intra-group (ICI), data = across groups.
    hierarchical_partitioning: bool = False
    # MiCS (reference runtime/zero/mics.py:63 MiCS_Init / :361
    # MiCS_Optimizer): bound the ZeRO-3 shard degree to a GROUP of
    # ``mics_shard_size`` devices (< world); params/grads/optimizer state
    # partition within the group and replicate across world/k groups, with
    # cross-group gradient allreduce keeping replicas in sync. On TPU this
    # IS a mesh factorization — fsdp=k (intra-group, rides ICI), data=world/k
    # (replica groups; grads psum there) — which ``initialize`` derives from
    # this knob; the reference's hierarchical cross-group allgather
    # (mics_hierarchical_params_gather) is what XLA's topology-aware
    # collective lowering does by construction. 0 = off.
    mics_shard_size: int = 0
    # Overlap-first DP backward: bucketed async grad rings + optional
    # cross-replica sharded weight update (parallel/grad_overlap.py).
    grad_overlap: GradOverlapConfig = field(default_factory=GradOverlapConfig)

    def _validate(self, path: str = "") -> None:
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"{path}stage: must be 0..3, got {self.stage}")
        if self.quantized_weights and self.stage != 3:
            raise ConfigError(
                f"{path}quantized_weights: qwZ quantizes the stage-3 weight "
                f"all-gather; it requires stage 3 (got stage {self.stage})")
        if self.qwz_block < 1:
            raise ConfigError(f"{path}qwz_block: must be >= 1")
        if self.quantized_gradients_bits not in (1, 4, 8):
            raise ConfigError(
                f"{path}quantized_gradients_bits: must be 1, 4 or 8, got "
                f"{self.quantized_gradients_bits}")
        if self.mics_shard_size < 0:
            raise ConfigError(
                f"{path}mics_shard_size: must be >= 0, got "
                f"{self.mics_shard_size}")
        if self.mics_shard_size > 0 and self.stage != 3:
            raise ConfigError(
                f"{path}mics_shard_size: MiCS bounds the stage-3 shard "
                f"degree; it requires stage 3 (got stage {self.stage})")
        if self.mics_shard_size > 0 and self.hierarchical_partitioning:
            raise ConfigError(
                f"{path}mics_shard_size: MiCS (opt state within the group) "
                "and hierarchical_partitioning (hpZ, opt state over the full "
                "world) prescribe conflicting master layouts; pick one")

    @classmethod
    def from_dict(cls, data, path: str = ""):
        data = dict(data or {})
        # Reference hpZ knob -> hierarchical partitioning (the group size is
        # implied by the mesh's fsdp axis here, not a free integer).
        if "zero_hpz_partition_size" in data:
            from deepspeed_tpu_torch.utils.logging import logger

            hpz = data.pop("zero_hpz_partition_size")
            try:
                hpz_on = int(hpz) > 0
            except (TypeError, ValueError):
                hpz_on = bool(hpz)  # "auto" etc.: treat truthy as enabled
            if hpz_on and "hierarchical_partitioning" not in data:
                logger.warning(
                    f"Config field '{path}zero_hpz_partition_size' maps to "
                    "'hierarchical_partitioning: true' in this build (the "
                    "secondary-partition group is the mesh's fsdp axis)."
                )
                data["hierarchical_partitioning"] = True
        # Reference MiCS gather knob: hierarchical cross-group allgather is
        # what XLA's topology-aware collective lowering already does; accept
        # the key so ported configs load, nothing to configure.
        data.pop("mics_hierarchical_params_gather", None)
        # Reference spellings for qwZ/qgZ (`zero_quantized_weights`,
        # `zero_quantized_gradients`).
        for ref_key, key in (("zero_quantized_weights", "quantized_weights"),
                             ("zero_quantized_gradients", "quantized_gradients")):
            if ref_key in data and key not in data:
                data[key] = data.pop(ref_key)
            else:
                data.pop(ref_key, None)
        # Legacy `cpu_offload` was a bool; translate to an offload tier, not a rename.
        if "cpu_offload" in data:
            from deepspeed_tpu_torch.utils.logging import logger

            logger.warning(
                f"Config field '{path}cpu_offload' is deprecated; use "
                f"'{path}offload_optimizer: {{device: cpu}}'."
            )
            legacy = data.pop("cpu_offload")
            if "offload_optimizer" not in data:
                if isinstance(legacy, bool):
                    data["offload_optimizer"] = {"device": "cpu" if legacy else "none"}
                else:
                    data["offload_optimizer"] = legacy
        return super().from_dict(data, path=path)


@dataclass
class MeshConfig(ConfigBase):
    """Named device-mesh axes. 'auto' (-1) sizes one axis from the device count.

    Axis vocabulary (fixed): data, fsdp, tensor, sequence, expert, pipeline.
    The DP world used in the batch triangle is data*fsdp (both consume batch).
    """

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipeline: int = 1
    # axes listed here are laid out over DCN (multi-slice) rather than ICI
    dcn_axes: list = field(default_factory=list)

    # set by Config.from_dict when the user wrote a mesh section; a default
    # (implicit) mesh must never tear down a pre-built topology
    @property
    def is_explicit(self) -> bool:
        return self.__dict__.get("_explicit_instance", False) or self != MeshConfig()

    def mark_explicit(self) -> None:
        self.__dict__["_explicit_instance"] = True

    def _validate(self, path: str = "") -> None:
        for name in ("fsdp", "tensor", "sequence", "expert", "pipeline"):
            if getattr(self, name) < 1:
                raise ConfigError(f"{path}{name}: must be >= 1")
        if self.data < -1 or self.data == 0:
            raise ConfigError(f"{path}data: must be -1 (auto) or >= 1")


@dataclass
class ActivationCheckpointingConfig(ConfigBase):
    """Rematerialization policy (reference: ``runtime/activation_checkpointing/``).

    On TPU this maps to ``jax.checkpoint`` policies on the scanned layer stack.
    """

    enabled: bool = False
    policy: str = "full"  # full | dots_saveable | nothing_saveable | offload_dots

    def _validate(self, path: str = "") -> None:
        if self.policy not in ("full", "dots_saveable", "nothing_saveable", "offload_dots"):
            raise ConfigError(f"{path}policy: unknown remat policy {self.policy!r}")


@dataclass
class MoEConfig(ConfigBase):
    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_coef: float = 0.01
    router_jitter: float = 0.0


@dataclass
class SequenceParallelConfig(ConfigBase):
    """Ulysses / ring attention (reference: ``deepspeed/sequence/``)."""

    mode: str = "ulysses"  # ulysses | ring
    # AutoSP (reference sequence/auto_sp.py): patch the standard attention
    # entry point (jax.nn.dot_product_attention) during tracing so user
    # models not written against ShardCtx get sequence parallelism
    # automatically (parallel/auto_sp.py)
    auto: bool = False
    tiled_mlp: bool = False
    tiled_logits: bool = False
    tile_size: int = 1024  # sequence tokens per ALST compute tile
    # FPDT chunked attention with host-offloaded residuals (reference
    # sequence/fpdt_layer.py): 0 = off; otherwise chunks (>= 2) over the
    # attention-visible sequence — under mode=ulysses that is the FULL
    # post-all-to-all sequence, not the per-rank shard, so size it against
    # the global context length.
    fpdt_chunks: int = 0
    fpdt_offload: bool = True

    def _validate(self, path: str = "") -> None:
        if self.mode not in ("ulysses", "ring"):
            raise ConfigError(f"{path}mode: must be ulysses|ring")
        if self.tile_size <= 0:
            raise ConfigError(f"{path}tile_size: must be positive")
        if self.fpdt_chunks < 0 or self.fpdt_chunks == 1:
            raise ConfigError(
                f"{path}fpdt_chunks: must be 0 (off) or >= 2, got "
                f"{self.fpdt_chunks}")
        if self.fpdt_chunks and self.mode == "ring":
            raise ConfigError(
                f"{path}fpdt_chunks: FPDT composes with mode=ulysses only "
                "(ring already chunks the KV loop across the ring)")


@dataclass
class PipelineConfig(ConfigBase):
    """Pipeline schedule config (reference: ``runtime/pipe/``).

    Two distinct runtimes share this block:

    - the in-jit SPMD pipelines (``parallel/pipeline.py`` /
      ``parallel/pipeline_1f1b.py``), enabled by a ``pipeline`` axis in the
      mesh — one XLA program, ppermute between stages;
    - the MPMD staged runtime (``runtime/pipe/``), enabled by ``stages > 1``
      — S separately-dispatched stage programs with activation send/recv
      over a transport, per-stage params + optimizer shards, crash-safe
      per-stage checkpoints.
    """

    num_microbatches: int = 0  # 0 => use gradient_accumulation_steps
    partition_method: str = "uniform"  # uniform | parameters
    activation_checkpoint_interval: int = 0
    # gpipe: collective forward pipeline + autodiff backward (O(M) stashes)
    # 1f1b:  interleaved schedule, P-deep stash, composes with fsdp
    #        (reference schedule.py:189 TrainSchedule)
    schedule: str = "gpipe"
    # MPMD staged runtime (runtime/pipe/): number of stage programs.
    # 0/1 = off (single-program engine); >1 routes deepspeed_tpu.initialize()
    # to the staged PipeEngine.
    stages: int = 0
    # virtual chunks per stage (interleaved 1F1B when > 1): stage s owns
    # chunks s, s+S, s+2S, ... of the layer range
    interleave: int = 1
    # activation/grad transport between stage programs: inproc = in-process
    # queues (one thread per stage, CPU-testable); device = reserved for
    # jax.device_put / collective-permute transports
    transport: str = "inproc"

    def _validate(self, path: str = "") -> None:
        if self.schedule not in ("gpipe", "1f1b"):
            raise ConfigError(f"{path}schedule: must be gpipe|1f1b")
        if self.stages < 0:
            raise ConfigError(f"{path}stages: must be >= 0, got {self.stages}")
        if self.interleave < 1:
            raise ConfigError(
                f"{path}interleave: must be >= 1, got {self.interleave}")
        if self.interleave > 1 and self.schedule != "1f1b":
            raise ConfigError(
                f"{path}interleave: interleaved chunks require "
                f"schedule='1f1b' (got {self.schedule!r})")
        if self.transport not in ("inproc", "device"):
            raise ConfigError(f"{path}transport: must be inproc|device")


@dataclass
class TensorParallelConfig(ConfigBase):
    """AutoTP equivalent (reference: ``module_inject/auto_tp.py``): declarative
    sharding-rule overrides applied to model params/activations."""

    enabled: bool = False
    rules: dict = field(default_factory=dict)  # param-name regex -> axis name


@dataclass
class MonitorConfig(ConfigBase):
    enabled: bool = False
    tensorboard: dict = field(default_factory=dict)  # {enabled, output_path, job_name}
    csv_monitor: dict = field(default_factory=dict)
    wandb: dict = field(default_factory=dict)
    comet: dict = field(default_factory=dict)  # {enabled, project, workspace, ...}


@dataclass
class CommsLoggerConfig(ConfigBase):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    prof_ops: list = field(default_factory=list)
    debug: bool = False
    # straggler analysis: warn when a collective's max/min latency across
    # processes exceeds this ratio
    straggler_warn_ratio: float = 2.0

    def _validate(self, path: str = "") -> None:
        if self.straggler_warn_ratio < 1.0:
            raise ConfigError(
                f"{path}straggler_warn_ratio: must be >= 1.0, got "
                f"{self.straggler_warn_ratio}")


@dataclass
class TelemetryConfig(ConfigBase):
    """Structured telemetry bus (``deepspeed_tpu/telemetry/``, see
    docs/OBSERVABILITY.md): metrics registry + span/event log with pluggable
    exporters. Disabled, every emit path is a single flag check."""

    enabled: bool = False
    # JSONL event-log sink (step spans, request spans, HBM watermarks, final
    # registry snapshot); None/"" disables the file sink
    jsonl_path: Optional[str] = None
    # {enabled, host, port}: Prometheus text exposition on a stdlib HTTP
    # server (port 0 = ephemeral)
    prometheus: dict = field(default_factory=dict)
    # sample accelerator.memory_stats() into hbm_* gauges every step
    hbm_watermarks: bool = True
    # mirror scalar telemetry events into the monitor writers (TensorBoard/
    # CSV/W&B/Comet become one sink among the exporters)
    monitor_sink: bool = False
    # flush the file sink every N emitted records
    flush_interval_events: int = 100
    # {enabled, interconnect_gbps, peak_tflops, use_cost_analysis,
    # profile_interval_steps, profile_dir, profile_keep}: training step
    # anatomy (telemetry/stepscope.py) — per-phase decomposition spans,
    # MFU attribution, overlap + goodput gauges. Enabling it settles every
    # step (microscope mode) and implies the trace ring on.
    # profile_interval_steps > 0 additionally opens a device-timeline
    # capture window (telemetry/devprof.py) every N steps: measured overlap
    # / wire-time / idle metrics, device ops merged into the trace ring;
    # capture dirs rotate under profile_dir (default runs/devprof, keep
    # profile_keep=4 most recent). Capture-bearing steps are excluded from
    # throughput and anatomy averages like recompile-bearing steps.
    stepscope: dict = field(default_factory=dict)
    # {enabled, census_interval_steps, drift_threshold, drift_consecutive,
    # report_dir} or bare true: HBM memory ledger (telemetry/memledger.py) —
    # per-owner byte attribution, jax.live_arrays() leak census, OOM crash
    # reports, headroom-driven admission inputs
    memledger: dict = field(default_factory=dict)

    def _validate(self, path: str = "") -> None:
        if self.flush_interval_events < 1:
            raise ConfigError(
                f"{path}flush_interval_events: must be >= 1, got "
                f"{self.flush_interval_events}")


@dataclass
class FlopsProfilerConfig(ConfigBase):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class CheckpointConfig(ConfigBase):
    use_node_local_storage: bool = False
    tag_validation: str = "warn"  # ignore | warn | fail
    load_universal: bool = False
    async_save: bool = False
    keep_n_latest: int = 0  # 0 = keep all

    def _validate(self, path: str = "") -> None:
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ConfigError(f"{path}tag_validation: must be ignore|warn|fail")


@dataclass
class ProgressiveLayerDropConfig(ConfigBase):
    """PLD schedule (reference ``runtime/progressive_layer_drop.py`` +
    ds_config key ``progressive_layer_drop``)."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001

    def _validate(self, path: str = "") -> None:
        if not (0.0 < self.theta <= 1.0):
            raise ConfigError(f"{path}theta: must be in (0, 1], got {self.theta}")


@dataclass
class EigenvalueConfig(ConfigBase):
    """Curvature probe (reference ``runtime/eigenvalue.py`` + engine
    ``eigenvalue`` config block): blockwise top-Hessian-eigenvalue power
    iteration, used to modulate quantization/compression schedules."""

    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "layers"
    layer_num: int = 0


@dataclass
class RandomLTDConfig(ConfigBase):
    """Random layerwise token dropping (reference ``runtime/data_pipeline/
    data_routing/basic_layer.py`` + ``csrc/random_ltd``): each decoder layer
    processes a random subset of tokens, ramping from ``start_keep_ratio``
    of the sequence back to 1.0 over ``total_steps`` (the reference's
    seq-length schedule). Kept counts are bucketed to ``bucket`` tokens —
    each bucket value is one compiled program."""

    enabled: bool = False
    start_keep_ratio: float = 0.5
    total_steps: int = 1000
    bucket: int = 64

    def _validate(self, path: str = "") -> None:
        if not 0.0 < self.start_keep_ratio <= 1.0:
            raise ConfigError(
                f"{path}start_keep_ratio: must be in (0, 1], got "
                f"{self.start_keep_ratio}")
        if self.total_steps < 1:
            raise ConfigError(f"{path}total_steps: must be >= 1")
        if self.bucket < 1:
            raise ConfigError(f"{path}bucket: must be >= 1")


@dataclass
class DataEfficiencyConfig(ConfigBase):
    enabled: bool = False
    curriculum_learning: dict = field(default_factory=dict)
    random_ltd: RandomLTDConfig = field(default_factory=RandomLTDConfig)


@dataclass
class TracingConfig(ConfigBase):
    """jax.profiler capture window (reference: nvtx instrumentation +
    ``utils/nvtx.py``; traces view in TensorBoard/XProf)."""

    enabled: bool = False
    trace_dir: str = "/tmp/dstpu_trace"
    start_step: int = 2   # skip compile steps
    num_steps: int = 3

    def _validate(self, path: str = "") -> None:
        if self.num_steps < 1:
            raise ConfigError(f"{path}num_steps: must be >= 1")


@dataclass
class DebugConfig(ConfigBase):
    """Semantic sanity checks + NaN trapping (reference §5.2:
    ``enable_sanity_checks``, CheckOverflow, debug-nans style checks)."""

    # trap the first NaN-producing op with a traceback (jax debug_nans)
    nans: bool = False
    # host-side batch validation each step (shapes, dtypes, divisibility)
    sanity_checks: bool = False


@dataclass
class SentinelConfig(ConfigBase):
    """Self-healing training (``runtime/sentinel.py``, see
    docs/FAULT_TOLERANCE.md "Training: self-healing"): a divergence verdict
    fused into the jitted train step (loss vs. rolling EMA + k·σ, grad-norm
    vs. rolling quantile, consecutive-skip streak), a quarantine →
    rollback-and-replay → reduce-lr/halt policy ladder, a dispatch watchdog,
    and a per-worker heartbeat file the elastic agent polls. Off by default:
    the disabled engine traces the exact same step program as before."""

    enabled: bool = False
    # ---- verdict thresholds (device-side, computed in the fused step)
    warmup_steps: int = 20          # accepted steps before the loss gate arms
    loss_ema_beta: float = 0.9      # EMA decay for loss mean/variance
    loss_sigma_k: float = 4.0       # anomalous when loss > ema + k*sigma
    loss_rel_floor: float = 0.05    # sigma floor as a fraction of |ema|
    grad_window: int = 32           # rolling grad-norm ring length
    grad_quantile: float = 0.95     # ring quantile the gate compares against
    grad_quantile_mult: float = 8.0 # anomalous when gnorm > mult * quantile
    # streak escalation threshold; matches precision.update_loss_scale
    # semantics exactly (streak resets to 0 on any accepted step, the way
    # good_steps resets on a single overflow)
    max_consecutive_skips: int = 5
    # ---- policy ladder (host-side, acts on settled verdicts)
    window_steps: int = 50          # strikes within this window escalate
    rollback: bool = True           # rung 2: restore + replay (else skip rung)
    checkpoint_dir: Optional[str] = None  # ladder restores from this save_dir
    on_third_strike: str = "halt"   # halt | reduce-lr
    lr_backoff: float = 0.5         # reduce-lr multiplier per backoff
    max_wedges: int = 3             # wedge timeouts in the window before halt
    report_dir: str = "sentinel_reports"  # forensics JSON directory
    state_dir: Optional[str] = None # quarantine persistence + heartbeat files
    # ---- liveness
    dispatch_timeout_s: float = 0.0 # >0: per-step settle under this deadline
    heartbeat_interval_s: float = 1.0  # min seconds between heartbeat writes

    def _validate(self, path: str = "") -> None:
        if self.on_third_strike not in ("halt", "reduce-lr"):
            raise ConfigError(
                f"{path}on_third_strike: must be halt|reduce-lr, got "
                f"{self.on_third_strike!r}")
        if not (0.0 < self.loss_ema_beta < 1.0):
            raise ConfigError(
                f"{path}loss_ema_beta: must be in (0, 1), got "
                f"{self.loss_ema_beta}")
        if self.grad_window < 4:
            raise ConfigError(
                f"{path}grad_window: must be >= 4, got {self.grad_window}")
        if not (0.0 < self.grad_quantile < 1.0):
            raise ConfigError(
                f"{path}grad_quantile: must be in (0, 1), got "
                f"{self.grad_quantile}")
        if not (0.0 < self.lr_backoff < 1.0):
            raise ConfigError(
                f"{path}lr_backoff: must be in (0, 1), got {self.lr_backoff}")
        if self.window_steps < 1:
            raise ConfigError(f"{path}window_steps: must be >= 1")


@dataclass
class AutotuningConfig(ConfigBase):
    """Tuned-profile loading at startup (reference ds_config
    ``autotuning`` block; docs/AUTOTUNING.md). When enabled,
    ``deepspeed_tpu.initialize`` looks up the persisted profile for
    (model fingerprint, topology, ``workload``) under ``profile_dir`` and
    fills knobs the config file did not write — explicit config values
    always win over tuned ones."""

    enabled: bool = False
    profile_dir: str = os.path.join("runs", "autotune")
    # workload class the profile was tuned on (one model can carry distinct
    # profiles for e.g. "default" vs "long-context" training recipes)
    workload: str = "default"


@dataclass
class Config(ConfigBase):
    """Top-level framework config (reference: ``DeepSpeedConfig``)."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_device: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    seed: int = 1234
    communication_data_type: Optional[str] = None  # e.g. "fp32" grad-reduce dtype
    prescale_gradients: bool = False
    sequence_length: Union[int, None] = None  # used by SP sharding + MFU accounting

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig
    )
    moe: MoEConfig = field(default_factory=MoEConfig)
    sequence_parallel: SequenceParallelConfig = field(default_factory=SequenceParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    tensor_parallel: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    data_efficiency: DataEfficiencyConfig = field(default_factory=DataEfficiencyConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(
        default_factory=ProgressiveLayerDropConfig)
    eigenvalue: EigenvalueConfig = field(default_factory=EigenvalueConfig)
    sentinel: SentinelConfig = field(default_factory=SentinelConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    # reference ds_config["compression_training"] shape, parsed by
    # deepspeed_tpu.compression.CompressionConfig (QAT + pruning schedules)
    compression_training: dict = field(default_factory=dict)

    _auto_fields: ClassVar[set] = {
        "train_batch_size",
        "train_micro_batch_size_per_device",
        "gradient_accumulation_steps",
    }
    _deprecated: ClassVar[dict] = {
        "train_micro_batch_size_per_gpu": "train_micro_batch_size_per_device",
        "zero": "zero_optimization",
    }

    @classmethod
    def from_dict(cls, data, path: str = ""):
        data = dict(data or {})
        # the reference takes `zenflow` at the top level of ds_config
        # (engine.py:391-396 glue); it lives under zero_optimization here
        if "zenflow" in data:
            zf = data.pop("zenflow")
            if isinstance(zf, dict):
                # presence of the block means "on" in the reference
                zf = {"enabled": True, **zf}
            # hoist into whichever spelling the user wrote — creating
            # 'zero_optimization' next to a legacy 'zero' block would make the
            # deprecation migration discard the user's 'zero' contents
            zo_key = "zero" if ("zero" in data
                                and "zero_optimization" not in data) else "zero_optimization"
            zo = dict(data.get(zo_key) or {})
            zo.setdefault("zenflow", zf)
            data[zo_key] = zo
        mesh_written = "mesh" in data
        obj = super().from_dict(data, path=path)
        if mesh_written:
            obj.mesh.mark_explicit()
        return obj

    # ------------------------------------------------------------------ batch triangle
    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Resolve train_batch = micro_batch * GAS * dp_world (reference: runtime/config.py).

        Any one of the three may be omitted/'auto'; the others determine it.
        """
        tb = None if is_auto(self.train_batch_size) else self.train_batch_size
        mb = None if is_auto(self.train_micro_batch_size_per_device) else self.train_micro_batch_size_per_device
        gas = None if is_auto(self.gradient_accumulation_steps) else self.gradient_accumulation_steps

        if tb is not None and mb is not None and gas is None:
            gas, rem = divmod(tb, mb * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch {mb} * dp_world {dp_world_size}"
                )
        elif tb is not None and gas is not None and mb is None:
            mb, rem = divmod(tb, gas * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by GAS {gas} * dp_world {dp_world_size}"
                )
        elif mb is not None and tb is None:
            gas = gas if gas is not None else 1
            tb = mb * gas * dp_world_size
        elif tb is not None and mb is None and gas is None:
            gas = 1
            mb, rem = divmod(tb, dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by dp_world {dp_world_size}"
                )
        elif tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ConfigError(
                    f"Inconsistent batch triangle: train_batch_size {tb} != "
                    f"micro {mb} * GAS {gas} * dp_world {dp_world_size}"
                )
        elif tb is None and mb is None:
            raise ConfigError(
                "Provide at least train_micro_batch_size_per_device or train_batch_size"
            )
        if gas is None:
            gas = 1
        if mb is None:
            raise ConfigError("Could not resolve micro batch size")
        self.train_batch_size = int(tb)
        self.train_micro_batch_size_per_device = int(mb)
        self.gradient_accumulation_steps = int(gas)

    def _validate(self, path: str = "") -> None:
        # reference: engine.py:1386 _assert_valid_mixed_precision_config.
        # bf16 defaults to auto (None): on unless fp16 was explicitly enabled.
        if self.fp16.enabled is True and self.bf16.enabled is True:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if self.bf16.enabled is None:
            self.bf16.enabled = not (self.fp16.enabled is True)

    @property
    def precision_name(self) -> str:
        if self.fp16.enabled is True:
            return "fp16"
        if self.bf16.enabled is True:
            return "bf16"
        return "fp32"

    @property
    def compute_dtype(self):
        import torch

        if self.fp16.enabled is True:
            return torch.float16
        if self.bf16.enabled in (True, None):
            return torch.bfloat16
        return torch.float32


def load_config(config: Union[str, dict, Config, None]) -> Config:
    """Accept a path to JSON, a dict, or an already-built Config."""
    if config is None:
        return Config()
    if isinstance(config, Config):
        return config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    return Config.from_dict(config)
