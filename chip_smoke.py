#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one CUDA card.

The port has two main paths, each driven at full width with random weights
from a seed: the ragged serving engine over Llama-3-8B (full depth, bf16),
and the training engine over Llama-3-8B's widths cut to 4 layers (bf16
compute over fp32 masters, AdamW, micro-batch 2 x 4096 tokens). In order:

1. device: the card, its power limit, torch and CUDA versions;
2. build: every kernel source in ``deepspeed_tpu_torch/ops/cuda/csrc`` with
   nvcc (one process per source, in parallel), with ptxas' registers,
   shared memory and spills;
3. kernels: each paged-attention kernel against its plain PyTorch version
   at the 8B serving shapes (decode also on a speculative verify batch of
   32 sequences x 5 consecutive positions), and each flash-attention kernel (forward,
   dK/dV, dQ) at the training shapes (B=2, S=4096, Hq=32, Hkv=8, D=128,
   causal), in bf16 and fp32; then timed beside its bound, its plain
   version and a library yardstick (SDPA, which the port never calls; the
   backward kernels' ``kernel_time`` lines add an estimate, not a
   measurement, of their part of SDPA's one backward call: its time times
   their share of the pair's flops); then ``head_dims``: all five kernels
   against their plain versions at head dims 16, 80, 96, 256, 264, 384,
   512, 1032 and 2048 in fp32 and bf16 (above 1024 the wide kernels' rows
   in a global workspace, the flash kernels there at S = 320 instead of
   1000; at 2048 also timed, for information), and a few
   training steps of ``LlamaConfig.tiny()`` (head dim 16) through the flash
   kernels;
4. engine: 32 requests x 48 greedy tokens through ``put()`` and
   ``generate_all()`` on the host-staged path (``device_state=False``), run
   twice on one engine, the second run reported, with the kernels' launch
   counts taken over that run alone; then a third run under
   ``torch.profiler`` for device time by kernel class;
5. parity: a mixed decode + prefill-tile step replayed through the kernels
   and through the plain attention path (bf16, 32 layers), and the same in
   fp32 on a 2-layer full-width model together with greedy tokens of a short
   run through both paths;
5a. engine_device: the same workload on the reference's default serving
   path: device-resident scheduler state with decode run-ahead 48, its
   decode-only programs replayed as CUDA graphs; warm-up run, measured run
   (graph replays, eager dispatches, H2D bytes in all and in steady decode,
   launches counted per replay), then a profiled run whose device sums
   from the kineto records are held to ``key_averages()``'s;
5b. parity_device: greedy tokens of the device-resident engine, with and
   without run-ahead, of the fused engine on the device path and on the
   host-staged path, and (parity_sched) of the device and fused paths with
   the scheduler, without and with speculation, against the host-staged
   engine (fp32, 2 layers at full width), and one captured decode-step graph of the 32-layer bf16
   model against ``llama.ragged_forward`` called eagerly;
5c. engine_fused: the same workload on the reference bench's own serving
   configuration (``bench.py:serve_trial_main``): fused mixed chunks of 16
   with three in flight, after ``warmup()`` captured the fused program
   family; warm-up run, measured run (every dispatch a graph replay, both
   kernels launched inside replays, the JAX engine's schedule), then a
   profiled run; then one mixed fused program (prefill tiles and a decode
   scan, 32 layers, bf16) captured and replayed against the same program
   run eagerly from the same state, and the KV it writes held to the rows
   and steps it schedules;
5d. engine_sched: the same configuration with the multi-step scheduler
   (``sched_steps=16``): ``warmup()`` captures the fused and scheduler
   families, every all-decode turn is one scheduler program whose
   iterations sit under CUDA graph conditional nodes; the JAX engine's
   schedule; a profiled run; then ``sched_program_check``: one 32-layer
   scheduler program captured and replayed against its eager run, its KV
   writes held to what it fed, and its early exit timed;
5e. engine_spec: the same with self-speculative decoding (``spec_draft=4``),
   its acceptance and its streams beside engine_sched's;
5f. sampling: threefry keys, ``fold_in``, words and uniforms on the card
   against the same calls on the CPU (identical), and ``sample_tokens``'
   distribution: 8 cases of temperature, top-k and top-p on and off, 2^18
   draws each, every category within 5 sigma of its filtered softmax
   probability and filtered-out ones never drawn;
5g. serve_trial: ``bench.py:serve_trial_main`` with engine_fused's engine
   against the dense ``InferenceEngine`` on its weights (padded batches of
   32, then one request at a time), then arrivals every 0.15 s, under the
   bench's keys; the dense engine's repeated shapes capture nothing, its
   replayed graphs match its eager run (bf16 full depth: at most
   ``DENSE_BF16_STREAMS_DIFFER`` streams differ; fp32 at 2 layers: none),
   and one dense call is profiled;
5g'. the HTTP serving tier (``deepspeed_tpu_torch/serving``), after the serve
   trial: ``serving``: ``bench.py:serving_bench_main``'s accelerator branch
   with engine_fused's engine (8B, bf16, no second ``warmup()``) behind
   ``build_server`` (``max_queue_tokens=2048``), telemetry on with its JSONL
   sink under runs/, an open-loop Poisson client streaming SSE (48
   requests of 48 tokens at 8/s): TTFT p50/p99, decode latency, 429s and
   goodput beside the card, every dispatch a replay and nothing captured,
   both kernels launched, /healthz ready, /metrics' request count, a clean
   drain (its launches fill the ``kernels`` line's ``launches_serving``);
   then in fp32 at 2 layers: ``serving_parity`` (direct runs with
   telemetry off and on, ``reset_state()`` between: the same dispatches,
   readbacks and synchronize calls, and the graph-held tensors unmoved;
   16 requests, half seeded, through HTTP equal to the host-staged
   engine's; a client ``traceparent`` propagated to the engine's spans),
   ``serving_cluster`` (``build_cluster_server`` over two engines sharing
   their weights, 8 requests on two shared 64-token prefixes: every
   request handed off, the prefix index hit, tokens equal to one engine's)
   and ``serving_chaos`` (``bench.py:_chaos_bench_impl``'s engine config and
   fault schedule, its ``checks`` all true);
5h. decode_steady: ``bench.py:decode_steady_main`` on the same weights:
   the device, host-staged and scheduler paths and the dense engine on 16
   x 96 tokens, the seeded parity matrix of all four dispatch modes
   (gated in fp32 at 2 layers, counted in bf16 at full depth), speculation
   on a repeated prompt and the dispatch economy of a staggered run;
5i. prefix_cache: the bench's serving configuration with the prefix cache
   on, after ``warmup()``, on bench.py's shared-prefix workload (a 96-token
   prefix: every tail starts mid-tile): a cold run, a run of fresh tails
   (32 hits of 3 blocks) and a repeat (32 hits of all but the last block),
   with hits, reused and scheduled prompt tokens, 0 captures and no leak
   gated; then hit vs cold tokens in the four dispatch modes, greedy and
   seeded, gated in fp32 at 2 layers;
5j. kv_tier: bench.py's --kv-tier workload (a 37-block pool, host and
   disk tiers under runs/, 24 arrivals of 12 prompts twice, prefetch
   kicked at arrival): demotions, spills, host promotions and prefetch
   hits gated in bf16 at full depth, both occurrences identical gated in
   fp32 at 2 layers; restore ms a block by tier and the tiers' bytes;
5k. handoff: the 32-request workload prefilled on one engine
   (``put(handoff=True)``), each record through ``to_bytes`` /
   ``from_bytes`` into a fused decode engine: tokens gated equal to a
   single engine's in fp32 at 2 layers, bf16 streams differing from
   engine_fused's counted; bytes a record and export / import ms;
5l. kv_quant: low-bit KV pools (``bench.py:1180-1249``'s ``--kv-quant``):
   ``quantize_kv_rows`` on the card bit for bit the CPU's; ``quant="int8"``
   and ``"fp8"`` on the fused config over the workload, each measured
   after a warm run (no capture, every dispatch a replay, 0 paged kernel
   launches: a quantized pool takes the plain path that dequantizes in its
   gather, counted; block and pool bytes; a replayed int8 decode step
   bit-identical to eager); the tier round trip of int8 payloads at 8B
   after ``warmup()`` (12 requests of kv_tier's workload: demotions,
   spills, host promotions, prefetch hits, restore ms a block by tier, the
   tiers' bytes at the quantized block's); int8 handoff records at 8B;
   ``bench.py:1381-1414``'s drift probe (printed, not gated); in fp32 at 2
   layers the int8 tokens of the device, fused, scheduler and speculation
   paths equal the host-staged int8 engine's, and the tier round trip and
   a handoff of int8 payloads reproduce the cold int8 tokens;
5m. woq: ``quantize_params`` on the card bit for bit the CPU's, ``woq8``
   and ``woq4`` on the fused config over the workload, each measured after
   a warm run (weights' bytes, tokens/s, the paged kernels launched as in
   bf16), the dense engine through ``init_inference(dtype="int8")``;
6. train: ``initialize`` with the config of ``bench.py:trial_main``, 2
   warm-up and 8 timed steps on fresh ``default_rng(0)`` batches with the
   flash kernels' launch counts per step, tokens/s, MFU and peak memory;
   one step under ``torch.profiler``; then 8 steps on one repeated batch,
   whose loss must fall;
7. train parity: loss, every gradient and a 4-step loss trajectory through
   the kernels vs through the plain attention path in fp32 (2 layers,
   full width, B=1, S=2048), and the gradients' relative error in bf16 at
   4 layers;
7a. train_fbs: the training cell at GAS 2 (two micro-batches of 1 x
   4096): 2 steps through ``backward`` x 2 + ``step`` and 2 through
   ``train_batch`` from the same init: losses and every master bit for bit;
   ms a step each way, ``forward``'s eval loss;
7b. hybrid: ``HybridEngine`` on the training cell, one ``train_batch``, then
   greedy ``generate`` and seeded rollouts: tokens equal a dense engine
   given ``eval_params`` (sharing them), one cast for the step;
7c. learn: ``bench.py:learn_trial_main``'s accelerator config (vocab 256,
   hidden 384, 6 layers, head dim 64, 32 x 512, 50 steps, WarmupLR) on the
   bytes of ``deepspeed_tpu/**/*.py`` with the sentinel on, then off:
   ``learn_pass``, 0 anomalies, losses bitwise equal, the same host reads a
   step both ways;
8. train_zero: the training cell at ZeRO stages 0, 1, 2 and 3 under a
   one-rank NCCL group on cuda:0 (``bench.py:173-176``'s ``mfu_zero3`` on
   one card), 4 batches each: stages 1-3 against stage 0's losses and grad
   norms (bitwise, else 1e-6 relative), 8 / 4 / 4 flash launches a step, no
   plain call, time a step, tokens/s, peak memory and the comms logger's
   rows;
9. checkpoint: Llama-3-8B widths at 1 layer (1,268,789,248 parameters) at
   stage 3 under NCCL trains 2 steps, saves (the JAX package's format and
   two-phase commit, under ``TMPDIR``), trains 2 more and saves a newer tag;
   one fragment of the newer tag is cut short; a fresh stage-0 engine loads
   the directory, walks the ladder past the corrupt tag to the older one,
   and its next 2 losses equal the continuous run's bit for bit; bytes
   written, save, verify and load seconds. The batches come from a
   ``CheckpointableLoader``; the older tag stays for 10 and 11;
10. sentinel: a stage-0 engine with the sentinel (``warmup_steps`` 3) loads
   that tag, takes nan-grads at ``train.grads`` and a poisoned batch at
   ``data.batch``: one quarantine, one rollback (a verified full-width
   load) and the replay, whose stitched losses equal a clean sentinel run
   pre-seeded with the quarantine, bit for bit; rollback seconds;
11. serve_from_checkpoint: ``InferenceEngine(checkpoint=)`` in bf16 and woq8
   on the tag: greedy tokens equal engines built from ``zero_to_fp32``'s
   arrays; load seconds and bytes on the device; a 1-layer
   ``HybridEngine`` loads the tag (its cast redone) and its tokens equal
   the bf16 engine's;
12. train_chaos: ``bench.py:_train_chaos_impl``'s legs at its worker config
   (the worker: ``deepspeed_tpu_torch/runtime/chaos.py``; all but the
   pipeline leg), started before 9 and run beside 9-11 (whose lines then
   carry ``beside_train_chaos``; ``--train-chaos-after`` runs them after 11
   instead), each leg a thread, its workers
   processes on the card using the libraries built in 2: the uninterrupted
   reference, kills at four checkpoint seams, a timer kill and
   ``corrupt-bytes`` at load, the elastic agent from world 2 to 1, the
   sentinel leg and the wedge leg; every check of ``bench.py:2848-2866``
   but the two ``pipe_*`` ones, and the seconds from each restart to its
   first new step.

Each phase prints one JSON line. The script ends with a ``{"kernels": ...}``
line and, as its last line, ``{"ok": true, "device": {...}}``; any failure
exits nonzero without that line. Run from the repository root:

    python3 chip_smoke.py [--train-chaos-after]
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import warnings
from functools import lru_cache, partial

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM, dense bf16 tensor cores

# RaggedConfig of bench.py's serve_trial_main accelerator branch (bench.py:281-289)
ENGINE = dict(max_tokens_per_step=1024, max_seqs=32, block_size=32,
              prefill_tile=128, max_blocks_per_seq=18, num_blocks=577)
N_REQ, MAX_NEW, PROMPT_LENS = 32, 48, (64, 128, 256, 512)
# 8B attention shapes
HQ, HKV, D, BS, MB, NB = 32, 8, 128, 32, 18, 577
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # paged decode; fp32 prefill
# bf16 flash and prefill checks: the flash kernels' fp32 lse to 1e-4, and
# the outputs to a relative Frobenius error between a correct kernel's
# rounding (flash: p and ds rounded to bf16 before their products; prefill:
# the output's own rounding) and the control, the plain version with the
# softmax scale one bf16 ulp (2^-7) too large
FLASH_LSE_ATOL, FLASH_BF16_REL_FRO, FLASH_CONTROL_SCALE = 1e-4, 5e-3, 1 + 2 ** -7
# training cell: bench.py:trial_main's config on Llama-3-8B widths at 4 layers
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 4096
TRAIN_CONFIG = {
    "train_micro_batch_size_per_device": TRAIN_BATCH, "gradient_accumulation_steps": 1,
    "steps_per_print": 0, "gradient_clipping": 1.0, "sequence_length": TRAIN_SEQ,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
    "zero_optimization": {"stage": 0}, "mesh": {"data": -1},
    "activation_checkpointing": {"enabled": True, "policy": "dots_saveable"},
}
WARMUP_STEPS, TIMED_STEPS = 2, 8
# flash-attention kernels at the training cell's attention shapes
FB, FS, FD = TRAIN_BATCH, TRAIN_SEQ, D


_START = time.perf_counter()


# set while the kill-and-resume legs run: every line printed then says so
BESIDE: dict = {}


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, **BESIDE,
                      "t_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi(*query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(query)}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30).stdout.strip()


# ------------------------------------------------------------------ timing
class L2Flush:
    """Evicts the 50 MB L2 between timed launches: the engine reads each
    layer's pool slice once per step, so the kernels meet it cold."""

    def __init__(self, torch):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


def cuda_ms(torch, fn, flush, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after an L2
    flush and bracketed by its own CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_ms_per_call(torch, fn, iters: int = 200) -> float:
    """Host time of one call of ``fn``: the wrapper's Python and the launch,
    not the card's work. Mean over ``iters`` calls queued back to back, with
    the card drained before the first; a kernel shorter than this shows it
    between ``cuda_ms``'s events, which bracket the host's enqueue."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


class PowerSampler:
    """nvidia-smi sampling SM clock and power draw beside a window."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        self.proc.terminate()
        try:
            out = self.proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out = self.proc.communicate()[0]
        clocks, watts = [], []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                clocks.append(float(parts[0]))
                watts.append(float(parts[1]))
            except (IndexError, ValueError):
                continue
        if not clocks:
            return {"samples": 0}
        return {"samples": len(clocks),
                "sm_clock_mhz_mean": sum(clocks) / len(clocks),
                "sm_clock_mhz_min": min(clocks), "sm_clock_mhz_max": max(clocks),
                "power_w_mean": sum(watts) / len(watts), "power_w_max": max(watts)}


# ------------------------------------------------------------ kernel cases
def _normal(shape, seed: int):
    """fp32 standard normals drawn on the card: at head dim 2048 a pool is
    302M values, which numpy took tens of seconds to draw."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device="cuda")


@lru_cache(maxsize=1)
def _decode_arrays(np, d: int):
    """decode_case's arrays at head dim d, K, V and Q as fp32 tensors on the
    card (a device dtype's cast rounds them once): the head-dim checks reuse
    them across dtypes."""
    rng = np.random.default_rng(0)
    pos = [0, 30, 31, 32, 33, 63, 64, 95, 96, 127, 128, 159, 160, 255, 256, 257,
           300, 383, 384, 400, 447, 448, 500, 511, 512, 530, 558, 559]
    max_seqs = 32
    bt = np.zeros((max_seqs + 1, MB), np.int32)
    perm = iter(rng.permutation(np.arange(1, NB)))
    for s, p in enumerate(pos):
        for j in range(p // BS + 1):
            bt[s, j] = next(perm)
    slots = list(range(len(pos))) + [max_seqs] * 4
    pos = pos + [0] * 4
    kp, vp = _normal((NB, BS, HKV, d), 10), _normal((NB, BS, HKV, d), 11)
    q = _normal((len(pos), HQ, d), 12)
    return q, kp, vp, slots, pos, bt


def decode_case(torch, np, dtype, d=D):
    """T = 32 tokens: 28 sequences with contexts 1..560 on and around block
    edges, each in its own slot with blocks drawn from a permutation of the
    pool, plus 4 padding tokens (slot max_seqs, position 0); head dim d."""
    q, kp, vp, slots, pos, bt = _decode_arrays(np, d)
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q.to(dtype, copy=True), kp.to(dtype, copy=True), vp.to(dtype, copy=True),
            torch.tensor(slots, **i32),
            torch.tensor(pos, **i32), torch.tensor(bt, **i32))


PREFILL_TILES = [(0, 0, 128), (0, 128, 128), (0, 256, 128), (0, 384, 128),
                 (1, 0, 128), (1, 128, 100), (2, 0, 64), (32, 0, 0)]


@lru_cache(maxsize=1)
def _prefill_arrays(np, d: int):
    """prefill_case's arrays at head dim d (fp32 on the card, as _decode_arrays)."""
    rng = np.random.default_rng(1)
    max_seqs = 32
    bt = np.zeros((max_seqs + 1, MB), np.int32)
    perm = iter(rng.permutation(np.arange(1, NB)))
    for s, length in ((0, 512), (1, 228), (2, 64)):
        for j in range(-(-length // BS)):
            bt[s, j] = next(perm)
    kp, vp = _normal((NB, BS, HKV, d), 20), _normal((NB, BS, HKV, d), 21)
    q = _normal((len(PREFILL_TILES) * 128, HQ, d), 22)
    return q, kp, vp, bt


def prefill_case(torch, np, dtype, d=D):
    """8 tiles of CT = 128 as the engine lays out a 1024-token step: a 512-
    token prompt (4 tiles), a 228-token prompt (pad rows), a 64-token prompt
    (pad rows) and one all-pad tile (slot max_seqs = 32); head dim d."""
    q, kp, vp, bt = _prefill_arrays(np, d)
    i32 = dict(dtype=torch.int32, device="cuda")
    meta = [torch.tensor(c, **i32) for c in zip(*PREFILL_TILES)]
    return (q.to(dtype, copy=True), kp.to(dtype, copy=True), vp.to(dtype, copy=True), *meta,
            torch.tensor(bt, **i32)), 128


def decode_work(args):
    """(bytes, flops) the decode call needs: each K/V block any token reads,
    read once, plus q and out; 4 flops per visible key, head and dim."""
    q, kp, _, slots, pos, bt = args
    bt, slots, pos = bt.cpu().numpy(), slots.cpu().tolist(), pos.cpu().tolist()
    blocks = {int(bt[s, j]) for s, p in zip(slots, pos) for j in range(p // BS + 1)}
    kv_block = BS * HKV * D * kp.element_size()
    nbytes = 2 * len(blocks) * kv_block + 2 * q.numel() * q.element_size()
    flops = 4 * sum(p + 1 for p in pos) * D * HQ
    return nbytes, flops


def prefill_work(args, ct):
    """(bytes, flops) the prefill call needs: each K/V block a valid row
    reads, read once; q of the valid rows only (a pad row's output is zero
    whatever its q holds); out of every row, since pad rows are written as
    zeros; 4 flops per visible key, head and dim."""
    q, kp, _, ts, tp, tv, bt = args
    bt = bt.cpu().numpy()
    blocks = set()
    visible = valid_rows = 0
    for s, p0, v in zip(ts.tolist(), tp.tolist(), tv.tolist()):
        if v:
            blocks |= {int(bt[s, j]) for j in range((p0 + v - 1) // BS + 1)}
            visible += sum(p0 + i + 1 for i in range(v))
            valid_rows += v
    kv_block = BS * HKV * D * kp.element_size()
    row = HQ * D * q.element_size()
    nbytes = 2 * len(blocks) * kv_block + (valid_rows + q.shape[0]) * row
    return nbytes, 4 * visible * D * HQ


def bound(nbytes, flops):
    """Least time (ms) the card could take for bf16 work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_decode(torch, args):
    """Library yardstick: SDPA over the same K/V pre-gathered into
    contiguous [T, Hq, C, D] tensors (the gather is not timed)."""
    from deepspeed_tpu_torch.ops.attention import repeat_kv

    q, kp, vp, slots, pos, bt = args
    t = q.shape[0]
    tables = bt.long()[slots.long()]
    k = repeat_kv(kp[tables].reshape(t, -1, HKV, D), HQ // HKV).transpose(1, 2).contiguous()
    v = repeat_kv(vp[tables].reshape(t, -1, HKV, D), HQ // HKV).transpose(1, 2).contiguous()
    mask = (torch.arange(k.shape[2], device="cuda")[None, :] <= pos.long()[:, None])
    qq, mask = q[:, :, None, :], mask[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def sdpa_prefill(torch, args, ct):
    from deepspeed_tpu_torch.ops.attention import repeat_kv

    q, kp, vp, ts, tp, tv, bt = args
    nt = ts.shape[0]
    tables = bt.long()[ts.long()]
    k = repeat_kv(kp[tables].reshape(nt, -1, HKV, D), HQ // HKV).transpose(1, 2).contiguous()
    v = repeat_kv(vp[tables].reshape(nt, -1, HKV, D), HQ // HKV).transpose(1, 2).contiguous()
    qq = q.reshape(nt, ct, HQ, D).transpose(1, 2).contiguous()
    qi = torch.arange(ct, device="cuda")
    kpos = torch.arange(k.shape[2], device="cuda")
    qpos = tp.long()[:, None] + qi[None, :]
    valid = qi[None, :] < tv.long()[:, None]
    mask = ((kpos[None, None, :] <= qpos[:, :, None]) & valid[:, :, None])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def prefill_check(torch, np, pa, d=D) -> dict:
    """The bf16 tensor-core prefill kernel against its plain version at
    ``prefill_case``: relative Frobenius error within FLASH_BF16_REL_FRO,
    beside the control (the plain version with the softmax scale one bf16
    ulp too large), which must lie beyond it; pad rows and the all-pad tile
    exact zeros."""
    args, ct = prefill_case(torch, np, torch.bfloat16, d)
    got = pa.ragged_prefill_attention(*args, ct)
    want = pa.ragged_prefill_attention_ref(*args, ct)
    control = pa.ragged_prefill_attention_ref(*args, ct, scale=FLASH_CONTROL_SCALE / d ** 0.5)
    torch.cuda.synchronize()
    _, _, _, _, _, tv, _ = args
    pad = torch.arange(ct, device="cuda")[None, :] >= tv.long()[:, None]  # [NT, CT]
    res = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
               rel_fro=rel_fro(got, want), control_rel_fro=rel_fro(control, want),
               pad_rows_zero=not got.reshape(pad.shape[0], ct, -1)[pad].any().item())
    res["ok"] = res["rel_fro"] <= FLASH_BF16_REL_FRO and res["pad_rows_zero"]  # False on a NaN
    return res


def kernel_phase(torch, np, pa):
    flush = L2Flush(torch)
    results = {}
    # decode runs as the engine runs it: on a workspace its cache owns
    workspace = pa.DecodeWorkspace("cuda", HQ, HKV, D)
    for name, make, kernel, ref, work, lib in (
            ("paged_decode", lambda dt: (decode_case(torch, np, dt), None),
             partial(pa.paged_decode_attention, workspace=workspace),
             pa.paged_decode_attention_ref,
             lambda a, ct: decode_work(a), lambda a, ct: sdpa_decode(torch, a)),
            ("paged_prefill", lambda dt: prefill_case(torch, np, dt),
             pa.ragged_prefill_attention, pa.ragged_prefill_attention_ref,
             prefill_work, lambda a, ct: sdpa_prefill(torch, a, ct))):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            if name == "paged_prefill" and dtype == torch.bfloat16:
                r = prefill_check(torch, np, pa)
                errs[dname] = r["max_abs_err"]
                check = (f"||got-want||_F / ||want||_F <= {FLASH_BF16_REL_FRO}, control "
                         "beyond it; pad rows exact zeros")
                emit("kernel_check", kernel=name, dtype=dname, check=check, **r)
                if not r["ok"]:
                    raise AssertionError(f"{name} {dname}: outside {check}: {r}")
                if not r["control_rel_fro"] > FLASH_BF16_REL_FRO:
                    raise AssertionError(f"{name}: the control (softmax scale one bf16 ulp "
                                         f"off) is within the limit {FLASH_BF16_REL_FRO}: {r}")
                continue
            args, ct = make(dtype)
            extra = () if ct is None else (ct,)
            got = kernel(*args, *extra)
            want = ref(*args, *extra)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dname]
            ok = within(torch, got, want, tol)
            errs[dname] = err
            emit("kernel_check", kernel=name, dtype=dname, max_abs_err=err,
                 check=f"|got-want| <= {tol} (1+|want|)", tol=tol, ok=ok)
            if not ok:
                raise AssertionError(f"{name} {dname}: max_abs_err {err} > {tol}")
        # timing at the main path's type (bf16)
        args, ct = make(torch.bfloat16)
        extra = () if ct is None else (ct,)
        ms = cuda_ms(torch, lambda: kernel(*args, *extra), flush)
        plain_ms = cuda_ms(torch, lambda: ref(*args, *extra), flush, iters=20)
        library_ms = cuda_ms(torch, lib(args, ct), flush)
        nbytes, flops = work(args, ct)
        bound_ms, bound_by = bound(nbytes, flops)
        results[name] = dict(max_abs_err=errs["bfloat16"], max_abs_err_fp32=errs["float32"],
                             ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        shape = {}
        if name == "paged_decode":  # the split count the wrapper picks at this shape
            q, _, _, _, _, bt = args
            shape["splits"] = pa.decode_splits(q.shape[0], HKV, bt.shape[1],
                                               torch.cuda.get_device_properties(0)
                                               .multi_processor_count)
        emit("kernel_time", kernel=name, dtype="bfloat16", bytes=nbytes, flops=flops,
             share_of_bound=bound_ms / ms,
             host_ms_per_call=host_ms_per_call(torch, lambda: kernel(*args, *extra)),
             **shape, **results[name])
        del args
    del flush
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------- flash kernels
FLASH_SHAPE = (FB, FS, HQ, HKV, FD)  # (B, S, Hq, Hkv, D) of the training cell


def flash_inputs(torch, dtype, seed=0, shape=FLASH_SHAPE):
    """q, k, v, dO of attention at ``shape``, drawn on the card."""
    b, s, hq, hkv, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(h):
        return torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)

    return draw(hq), draw(hkv), draw(hkv), draw(hq)


def flash_work(dtype_bytes: int):
    """(bytes, flops) of each flash kernel at the cell's shapes, causal: the
    (query, key) pairs it must visit are S (S + 1) / 2 per batch and head;
    2 flops per pair and head dim for each product (forward: s and p v;
    dK/dV: s, dp, dv, dk; dQ: s, dp, dq); each input read once, each output
    written once (lse and delta fp32)."""
    pairs = FB * HQ * FS * (FS + 1) // 2
    q = FB * FS * HQ * FD * dtype_bytes   # also o, dO, dq
    kv = FB * FS * HKV * FD * dtype_bytes  # each of k, v, dk, dv
    rows = FB * HQ * FS * 4                # lse or delta
    return {"flash_fwd": (q + 2 * kv + q + rows, 4 * FD * pairs),
            "flash_dkdv": (2 * q + 2 * kv + 2 * rows + 2 * kv, 8 * FD * pairs),
            "flash_dq": (2 * q + 2 * kv + 2 * rows + q, 6 * FD * pairs)}


def within(torch, got, want, tol) -> bool:
    """|got - want| <= tol (1 + |want|) everywhere (torch.allclose with
    atol = rtol = tol): the fp32 check, where only summation order differs."""
    return bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))


def rel_fro(got, want) -> float:
    """||got - want||_F / ||want||_F."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def flash_check(torch, fa, dtype, shape=FLASH_SHAPE) -> dict:
    """Each flash kernel against its plain version on the same inputs at
    ``shape`` (the training cell's by default), causal; the backward kernels
    get the plain forward's o and lse, so only they differ. Per kernel: max
    abs error and whether it passes. fp32: |got - want| <= 1e-4 (1 + |want|)
    for every output. bf16: lse (fp32 in both) within FLASH_LSE_ATOL, and o,
    dq, dk, dv each within FLASH_BF16_REL_FRO relative Frobenius error;
    beside it the control: the plain version with the softmax scale one bf16
    ulp too large, which must lie beyond the limit, so the limit is shown to
    tell such a fault from rounding."""
    q, k, v, do = flash_inputs(torch, dtype, shape=shape)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, True)
    dq_ref, dk_ref, dv_ref = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, True)
    torch.cuda.synchronize()
    outs = {"flash_fwd": {"o": (o, o_ref)},
            "flash_dkdv": {"dk": (dk, dk_ref), "dv": (dv, dv_ref)},
            "flash_dq": {"dq": (dq, dq_ref)}}
    res = {name: {"max_abs_err": max((a.float() - b.float()).abs().max().item()
                                     for a, b in pairs.values())}
           for name, pairs in outs.items()}
    lse_err = (lse - lse_ref).abs().max().item()
    res["flash_fwd"]["max_abs_err"] = max(res["flash_fwd"]["max_abs_err"], lse_err)
    if dtype == torch.float32:
        tol = TOL["float32"]
        res["flash_fwd"]["ok"] = within(torch, o, o_ref, tol) and within(torch, lse, lse_ref, tol)
        for name in ("flash_dkdv", "flash_dq"):
            res[name]["ok"] = all(within(torch, a, b, tol) for a, b in outs[name].values())
    else:
        scale = FLASH_CONTROL_SCALE / shape[-1] ** 0.5
        o_c, _ = fa.flash_attention_fwd_ref(q, k, v, True, scale)
        dq_c, dk_c, dv_c = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, True, scale)
        control = {"o": o_c, "dq": dq_c, "dk": dk_c, "dv": dv_c}
        for name, pairs in outs.items():
            r = res[name]
            r["rel_fro"] = {n: rel_fro(a, b) for n, (a, b) in pairs.items()}
            r["control_rel_fro"] = {n: rel_fro(control[n], b) for n, (_, b) in pairs.items()}
            r["max_err_over_rms"] = {
                n: ((a.float() - b.float()).abs().max() / b.float().pow(2).mean().sqrt()).item()
                for n, (a, b) in pairs.items()}
            r["ok"] = max(r["rel_fro"].values()) <= FLASH_BF16_REL_FRO  # False on a NaN
        res["flash_fwd"]["lse_abs_err"] = lse_err
        res["flash_fwd"]["ok"] = res["flash_fwd"]["ok"] and lse_err <= FLASH_LSE_ATOL
        del o_c, dq_c, dk_c, dv_c, control
    del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref, dv_ref, outs
    torch.cuda.empty_cache()
    return res


def flash_kernel_phase(torch, fa):
    """Each flash kernel against its plain version, in fp32 and bf16, at the
    training cell's shapes; then times in bf16 beside bounds, the plain
    versions and SDPA."""
    flush = L2Flush(torch)
    errs: dict = {}
    limits = {"float32": "|got-want| <= 1e-4 (1+|want|), o, lse, dq, dk, dv",
              "bfloat16": f"lse |got-want| <= {FLASH_LSE_ATOL}; o, dq, dk, dv "
                          f"||got-want||_F / ||want||_F <= {FLASH_BF16_REL_FRO}"}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, r in flash_check(torch, fa, dtype).items():
            errs.setdefault(name, {})[dname] = r
            emit("kernel_check", kernel=name, dtype=dname, shape=list(FLASH_SHAPE),
                 causal=True, check=limits[dname], **r)
            if not r["ok"]:
                raise AssertionError(f"{name} {dname}: outside {limits[dname]}: {r}")
            if dname == "bfloat16" and not min(r["control_rel_fro"].values()) > \
                    FLASH_BF16_REL_FRO:
                raise AssertionError(f"{name}: the control (softmax scale one bf16 ulp off) "
                                     f"is within the limit {FLASH_BF16_REL_FRO}: {r}")

    # timing at the main path's type (bf16)
    q, k, v, do = flash_inputs(torch, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    times = {
        "flash_fwd": cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True), flush),
        "flash_dkdv": cuda_ms(torch, lambda: fa.flash_attention_dkdv(q, k, v, do, lse, delta,
                                                                    True), flush),
        "flash_dq": cuda_ms(torch, lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, True),
                            flush),
    }
    plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_fwd_ref(q, k, v, True), flush,
                        iters=5, warmup=1)
    # the plain backward computes dq, dk and dv together
    plain_bwd = cuda_ms(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True),
                        flush, iters=5, warmup=1)
    # SDPA in its own [B, H, S, D] layout; its backward (dq, dk, dv together)
    # through autograd
    sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdo = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                                                enable_gqa=True)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(torch, sdpa, flush)
    so = sdpa()
    sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                                          retain_graph=True), flush)
    plain = {"flash_fwd": plain_fwd, "flash_dkdv": plain_bwd, "flash_dq": plain_bwd}
    library = {"flash_fwd": sdpa_fwd, "flash_dkdv": sdpa_bwd, "flash_dq": sdpa_bwd}
    work = flash_work(2)
    # SDPA's backward computes dq, dk and dv in one call, whose split is not
    # measured: the kernel_time lines estimate each backward kernel's part as
    # that call's time times its share of the pair's flops (dK/dV 8/14, dQ
    # 6/14); the kernels line keeps the measured whole-call time only
    pair_flops = work["flash_dkdv"][1] + work["flash_dq"][1]
    share = {name: work[name][1] / pair_flops for name in ("flash_dkdv", "flash_dq")}
    results = {}
    for name, (nbytes, flops) in work.items():
        bound_ms, bound_by = bound(nbytes, flops)
        bf = errs[name]["bfloat16"]
        results[name] = dict(max_abs_err=bf["max_abs_err"], rel_fro=max(bf["rel_fro"].values()),
                             max_abs_err_fp32=errs[name]["float32"]["max_abs_err"],
                             ms=times[name],
                             plain_ms=plain[name], library_ms=library[name],
                             bound_ms=bound_ms, bound_by=bound_by)
        estimate = {} if name == "flash_fwd" else dict(
            library_flop_share_estimate_ms=library[name] * share[name])
        emit("kernel_time", kernel=name, dtype="bfloat16", shape=list(FLASH_SHAPE),
             bytes=nbytes, flops=flops, share_of_bound=bound_ms / times[name],
             achieved_tflops=flops / times[name] / 1e9,
             library="SDPA forward" if name == "flash_fwd" else
             "SDPA backward (dq, dk, dv together)", **results[name], **estimate)
    del q, k, v, do, o, lse, delta, sq, sk, sv, sdo, so, flush
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- head dims
# taken by the reference's kernels, besides 64 and 128; above 256 the wide
# kernels (csrc/wide_head.cu), above 1024 with their rows in a global workspace
HEAD_DIMS = (16, 80, 96, 256, 264, 384, 512, 1032, 2048)
HEAD_DIM_TIMED = 2048  # timed too, for information: no model has such a head dim
HEAD_DIM_FLASH = (1, 1000, 8, 2)  # (B, S, Hq, Hkv): GQA rep 4, S off the 128-row tile


def head_dim_checks(torch, np, pa, fa, d: int, dtype) -> dict:
    """All five kernels against their plain versions at head dim d, with the
    kernel phase's checks: paged decode |got - want| <= TOL (1 + |want|);
    prefill fp32 the same at 1e-4, bf16 relative Frobenius within
    FLASH_BF16_REL_FRO beside its control, pad rows exact zeros; the flash
    kernels as ``flash_check`` at ``HEAD_DIM_FLASH``, causal."""
    dname = str(dtype).split(".")[1]
    tol = TOL[dname]
    out = {}
    args = decode_case(torch, np, dtype, d)
    got, want = pa.paged_decode_attention(*args), pa.paged_decode_attention_ref(*args)
    out["paged_decode"] = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                               ok=within(torch, got, want, tol))
    if dtype == torch.bfloat16:
        r = prefill_check(torch, np, pa, d)
        r["ok"] = r["ok"] and r["control_rel_fro"] > FLASH_BF16_REL_FRO
    else:
        args, ct = prefill_case(torch, np, dtype, d)
        got, want = pa.ragged_prefill_attention(*args, ct), pa.ragged_prefill_attention_ref(*args, ct)
        r = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                 ok=within(torch, got, want, tol))
    out["paged_prefill"] = r
    for name, r in flash_check(torch, fa, dtype, shape=(*HEAD_DIM_FLASH, d)).items():
        if dtype == torch.bfloat16:
            r["ok"] = r["ok"] and min(r["control_rel_fro"].values()) > FLASH_BF16_REL_FRO
        out[name] = r
    del args, got, want
    torch.cuda.empty_cache()
    return out


def head_dim_times(torch, np, pa, fa, d: int) -> dict:
    """Device ms (bf16, mean of 5 launches after an L2 flush) of the five
    kernels at head dim d, on the head-dim checks' inputs."""
    flush = L2Flush(torch)
    dec = decode_case(torch, np, torch.bfloat16, d)
    pre, ct = prefill_case(torch, np, torch.bfloat16, d)
    q, k, v, do = flash_inputs(torch, torch.bfloat16, shape=(*HEAD_DIM_FLASH, d))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {"paged_decode": lambda: pa.paged_decode_attention(*dec),
             "paged_prefill": lambda: pa.ragged_prefill_attention(*pre, ct),
             "flash_fwd": lambda: fa.flash_attention_fwd(q, k, v, True),
             "flash_dkdv": lambda: fa.flash_attention_dkdv(q, k, v, do, lse, delta, True),
             "flash_dq": lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, True)}
    out = {name: cuda_ms(torch, fn, flush, iters=5, warmup=1) for name, fn in calls.items()}
    del dec, pre, q, k, v, do, o, lse, delta, flush
    torch.cuda.empty_cache()
    return out


def head_dims_phase(torch, np, pa, fa, llama, engine_mod) -> None:
    """Every head dim the reference's kernels take runs on a hand-written
    kernel: the five kernels at HEAD_DIMS in fp32 and bf16, then
    ``LlamaConfig.tiny()`` (head dim 16) trained on one repeated batch
    through ``initialize`` / ``train_batch``: the flash kernels launch, the
    plain versions are never called, and the loss falls."""
    failed = []
    for d in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            res = head_dim_checks(torch, np, pa, fa, d, dtype)
            emit("head_dim_check", head_dim=d, dtype=dname, decode_tol=TOL[dname],
                 flash_shape=[*HEAD_DIM_FLASH, d], kernels=res)
            failed += [f"{name} d={d} {dname}" for name, r in res.items() if not r["ok"]]
    emit("head_dim_time", head_dim=HEAD_DIM_TIMED, dtype="bfloat16", decode_shape="decode_case",
         prefill_shape="prefill_case", flash_shape=[*HEAD_DIM_FLASH, HEAD_DIM_TIMED],
         ms=head_dim_times(torch, np, pa, fa, HEAD_DIM_TIMED))
    _decode_arrays.cache_clear()
    _prefill_arrays.cache_clear()

    cfg = llama.LlamaConfig.tiny()
    fa.reset_counts()
    eng, _, _, _ = engine_mod.initialize(
        model=partial(llama.build, cfg), seed=0,
        config={"train_micro_batch_size_per_device": 2, "steps_per_print": 0,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}})
    batch = {"input_ids": np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128),
                                                            dtype=np.int32)}
    losses = [float(eng.train_batch(batch)) for _ in range(8)]
    launches = flash_counts(fa)
    plain_calls = fa.flash_attention_fwd_ref.calls + fa.flash_attention_bwd_ref.calls
    emit("head_dims_train", model="LlamaConfig.tiny()", head_dim=cfg.hd,
         compute_dtype=str(eng.config.compute_dtype), losses=losses, kernel_launches=launches,
         plain_version_calls=plain_calls)
    del eng
    torch.cuda.empty_cache()
    if min(launches.values()) <= 0:
        failed.append(f"tiny training launched no flash kernel: {launches}")
    if plain_calls:
        failed.append(f"tiny training called the plain attention {plain_calls} times")
    if not losses[-1] < losses[0]:
        failed.append(f"tiny training's loss did not fall: {losses}")
    if failed:
        raise AssertionError(f"head_dims: {failed}")


# ------------------------------------------------------------------ engine
def requests(np, vocab):
    """bench.py serve_trial_main's workload: 32 prompts of 64/128/256/512
    tokens shuffled by default_rng(0)."""
    rng = np.random.default_rng(0)
    lens = [int(PROMPT_LENS[i % len(PROMPT_LENS)]) for i in range(N_REQ)]
    rng.shuffle(lens)
    return [rng.integers(0, vocab, (n,), dtype=np.int32) for n in lens]


def run(engine, prompts, max_new):
    for i, p in enumerate(prompts):
        engine.put(i, p, max_new_tokens=max_new)
    return engine.generate_all()


class StepCapture:
    """Wraps an engine's forward to keep the inputs and a copy of the cache
    of the first step that mixes decodes with prefill tiles."""

    def __init__(self, engine):
        self.engine = engine
        self.fwd = engine.spec.ragged_forward_fn
        self.saved = None
        engine.spec = dataclasses.replace(engine.spec, ragged_forward_fn=self)

    def __call__(self, params, tokens, slots, positions, bt, cache, prefill_tiles=None):
        if (self.saved is None and prefill_tiles is not None and prefill_tiles[0] > 0
                and tokens.shape[0] > prefill_tiles[0]):
            self.saved = dict(
                inputs=(tokens.clone(), slots.clone(), positions.clone(), bt.clone()),
                tiles=(prefill_tiles[0], *(t.clone() for t in prefill_tiles[1:4]),
                       prefill_tiles[4]),
                cache={k: cache[k].clone() for k in ("k", "v")})
        return self.fwd(params, tokens, slots, positions, bt, cache,
                        prefill_tiles=prefill_tiles)

    def restore(self):
        self.engine.spec = dataclasses.replace(self.engine.spec, ragged_forward_fn=self.fwd)


def replay(torch, llama, cfg, params, saved, max_seqs):
    """The captured step through the kernels and through the plain path,
    each on its own copy of the cache; logits of the real (non-pad) rows."""
    out = {}
    for impl in ("auto", "plain"):
        cache = {k: v.clone() for k, v in saved["cache"].items()}
        logits, _ = llama.ragged_forward(cfg, params, *saved["inputs"], cache,
                                         prefill_tiles=saved["tiles"], attn_impl=impl)
        out[impl] = logits.float()
        del cache
    real = saved["inputs"][1] != max_seqs
    a, b = out["auto"][real], out["plain"][real]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits in the replayed step")
    rel = ((a - b).norm() / b.norm()).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return dict(rows=int(real.sum()), n_dec=int(saved["tiles"][0]),
                n_tiles=int(saved["tiles"][1].numel()), rel_frobenius_err=rel,
                max_abs_err=(a - b).abs().max().item(), top1_agreement=top1)


def launch_counts(pa):
    """The paged kernels' launch counts, and the plain versions' calls."""
    return ({"paged_decode": pa.paged_decode_attention.launches,
             "paged_prefill": pa.ragged_prefill_attention.launches},
            pa.paged_decode_attention_ref.calls + pa.ragged_prefill_attention_ref.calls)


def kernel_class(name: str) -> str:
    for kernel in ("paged_decode", "paged_prefill", "flash_fwd", "flash_dkdv", "flash_dq"):
        if kernel in name:
            return kernel
    if "foreach" in name or "multi_tensor" in name:
        return "foreach (optimizer, clipping)"
    low = name.lower()
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "index" in low or "scatter" in low or "gather" in low:
        return "index"
    return "other"


def profile_phase(torch, work, phase="profile", cross_check=False):
    """``work()`` under torch.profiler, CUDA activity alone (no host
    events: recording and averaging those took most of the profiled runs'
    time): device time by kernel class and the device's busy share of the
    wall time (the profiler's own host overhead lengthens that wall time).
    The device events are summed by name straight from the profiler's
    kineto records (``prof.profiler.kineto_results``, not a public
    interface): building ``key_averages()``'s Python events for ~10^5
    kernels took 20-80 s a profiled run. ``cross_check``: also sum them
    through ``key_averages()`` and fail unless both give the same events
    and times by class (to 0.1 % of the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    kernels: dict[str, list] = {}  # name -> [count, device ns]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += 1
            k[1] += e.duration_ns()
    by_class: dict[str, float] = {}
    for name, (_, ns) in kernels.items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ns / 1e6
    busy = sum(by_class.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    aggregate_s = time.perf_counter() - t1
    check = {}
    if cross_check:
        t2 = time.perf_counter()
        avg: dict[str, float] = {}
        events = 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                c = kernel_class(e.key)
                avg[c] = avg.get(c, 0.0) + e.self_device_time_total / 1e3
                events += e.count
        diff = max(abs(avg.get(c, 0.0) - by_class.get(c, 0.0)) for c in {*avg, *by_class})
        check = dict(key_averages_ms_by_class=avg, key_averages_events=events,
                     kineto_events=sum(n for n, _ in kernels.values()),
                     key_averages_max_abs_diff_ms=diff,
                     key_averages_s=time.perf_counter() - t2, torch=torch.__version__)
    emit(phase, wall_ms=wall * 1e3, device_busy_ms=busy,
         device_busy_share=busy / (wall * 1e3), device_ms_by_class=by_class,
         top_kernels=[{"name": name[:90], "count": n, "device_ms": ns / 1e6}
                      for name, (n, ns) in top],
         activities="cuda", stop_s=t1 - (t0 + wall), aggregate_s=aggregate_s, **check)
    if busy <= 0:
        raise AssertionError(f"{phase}: the profiler recorded no device time")
    if check and (check["key_averages_events"] != check["kineto_events"]
                  or check["key_averages_max_abs_diff_ms"] > 1e-3 * busy):
        raise AssertionError(f"{phase}: the kineto records and key_averages() disagree: "
                             f"{check} against {by_class}")


def engine_phase(torch, np, llama, ragged, pa):
    cfg = llama.LlamaConfig.llama3_8b()
    rcfg = ragged.RaggedConfig(**ENGINE, device_state=False)
    t0 = time.perf_counter()
    eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [eng.params["embed"], eng.params["final_norm"], eng.params["lm_head"],
                       *eng.params["layers"].values()])
    pool_bytes = sum(eng.cache[k].numel() * eng.cache[k].element_size() for k in ("k", "v"))
    emit("engine_init", model="llama3_8b", layers=cfg.num_layers, hidden=cfg.hidden_size,
         vocab=cfg.vocab_size, num_params=llama.num_params(cfg), param_bytes=param_bytes,
         kv_pool_bytes=pool_bytes, ragged_config=ENGINE, init_s=time.perf_counter() - t0)
    prompts = requests(np, cfg.vocab_size)

    # run 1: warm-up, also capturing a mixed step for the parity phase
    cap = StepCapture(eng)
    t0 = time.perf_counter()
    out = run(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cap.restore()
    if any(len(v) != MAX_NEW for v in out.values()):
        raise AssertionError("warm-up run: a request did not return 48 tokens")

    # run 2, the measured one: counts zeroed just before, read just after
    steps0, stage0, h2d0 = eng.dispatch_count, eng.host_stage_ns, eng.h2d_bytes
    torch.cuda.reset_peak_memory_stats()
    pa.reset_counts()
    sampler = PowerSampler()
    try:
        t0 = time.perf_counter()
        out = run(eng, prompts, MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        power = sampler.stop()
    launches, plain_calls = launch_counts(pa)
    gen = sum(len(v) for v in out.values())
    emit("engine_run", path="host-staged", requests=len(out), new_tokens_each=MAX_NEW,
         generated_tokens=gen,
         prompt_tokens=int(sum(len(p) for p in prompts)), wall_s=wall,
         generated_tokens_per_s=gen / wall, warmup_wall_s=warm_s,
         steps=eng.dispatch_count - steps0, preemptions=eng.preemptions,
         kernel_launches=launches,
         host_stage_s=(eng.host_stage_ns - stage0) / 1e9, h2d_bytes=eng.h2d_bytes - h2d0,
         plain_version_calls=plain_calls, free_blocks=eng.allocator.free_blocks,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), **power)
    if len(out) != N_REQ or any(len(v) != MAX_NEW for v in out.values()):
        raise AssertionError("a request did not return 48 tokens")
    if any(not 0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("a token outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if plain_calls:
        raise AssertionError(f"plain attention ran {plain_calls} times on the main path")
    if eng.allocator.free_blocks != rcfg.num_blocks - 1:
        raise AssertionError("KV blocks leaked")
    max_memory = torch.cuda.max_memory_allocated()

    profile_phase(torch, lambda: run(eng, prompts, MAX_NEW))
    if cap.saved is None:
        raise AssertionError("no step mixed decodes with prefill tiles")
    res = replay(torch, llama, cfg, eng.params, cap.saved, rcfg.max_seqs)
    emit("parity_bf16", model="llama3_8b", layers=cfg.num_layers, **res,
         rel_frobenius_bound=5e-2)
    if res["rel_frobenius_err"] > 5e-2:
        raise AssertionError(f"bf16 logits rel err {res['rel_frobenius_err']} > 5e-2")
    del eng, cap
    torch.cuda.empty_cache()
    return launches, dict(max_memory_allocated_bytes=max_memory,
                          generated_tokens_per_s=gen / wall)


def parity_fp32_phase(torch, np, llama, ragged):
    """2 of Llama-3-8B's 32 layers at full width, fp32: logits of a mixed
    step through the kernels vs the plain path (atol 1e-3), and greedy tokens
    of 8 short requests through each path (host-staged engines)."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    rcfg = ragged.RaggedConfig(**ENGINE, device_state=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init_params(cfg, gen, torch.float32, "cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (40, 64, 100, 33, 150, 7, 80, 129)]
    toks = {}
    saved = None
    for impl in ("auto", "plain"):
        spec = dataclasses.replace(
            llama.build(cfg), ragged_forward_fn=partial(llama.ragged_forward, cfg,
                                                        attn_impl=impl))
        eng = ragged.RaggedInferenceEngine(spec, rcfg, dtype=torch.float32, params=params)
        cap = StepCapture(eng) if impl == "auto" else None
        toks[impl] = run(eng, prompts, 8)
        if cap is not None:
            saved = cap.saved
            cap.restore()  # breaks the engine <-> capture cycle, so del frees the params
        del eng, cap
    if saved is None:
        raise AssertionError("no step mixed decodes with prefill tiles")
    res = replay(torch, llama, cfg, params, saved, rcfg.max_seqs)
    same = toks["auto"] == toks["plain"]
    emit("parity_fp32", model="llama3_8b widths", layers=2,
         reduced="depth 32 -> 2 layers", **res, atol=1e-3, greedy_requests=len(prompts),
         greedy_tokens_identical=same)
    if res["max_abs_err"] > 1e-3:
        raise AssertionError(f"fp32 logits max err {res['max_abs_err']} > 1e-3")
    if not same:
        raise AssertionError("fp32 greedy tokens differ between kernels and plain path")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------- device-resident
RUN_AHEAD = 48  # bench.py:289,324's decode_run_ahead
# bench.py:289-290,318-336: fused chunks of 16, three in flight
FUSED_CHUNK, PIPELINE_DEPTH = 16, 3
FUSED = dict(device_state=True, decode_run_ahead=RUN_AHEAD, fused_chunk=FUSED_CHUNK,
             pipeline_depth=PIPELINE_DEPTH)
# the JAX engine's schedule of the 32 x 48 workload at ENGINE + FUSED:
# (dispatches, scheduled tokens, padded tokens), and its warmup family's
# size; tests/test_torch_ragged_fused.py holds both engines to them
FUSED_SCHEDULE = (12, 9216, 4608)
FUSED_WARMUP_PROGRAMS = 29
# the multi-step scheduler on top (bench.py's serve probe sweeps
# sched_steps over {0, 8, 16} and spec_draft over {0, 4},
# deepspeed_tpu/autotuning/knobs.py:159,169), and self-speculation
SCHED_STEPS, SPEC_DRAFT, SPEC_NGRAM = 16, 4, 3
SCHED = dict(FUSED, sched_steps=SCHED_STEPS)
SPEC = dict(SCHED, spec_draft=SPEC_DRAFT, spec_ngram=SPEC_NGRAM)
# the JAX engine's schedule of the workload at ENGINE + SCHED (dispatches,
# scheduled tokens, padded tokens), the port's split of its dispatches into
# fused chunks and scheduler programs, and the warmup family's size (fused
# and scheduler programs); tests/test_torch_ragged_sched.py holds both
# engines to them
SCHED_SCHEDULE = (15, 9206, 3526)
SCHED_DISPATCHES = (9, 6)
SCHED_WARMUP_PROGRAMS = 49


def engine_counters(eng) -> dict:
    p = eng.programs
    return dict(steps=eng.dispatch_count, forwards=eng.forwards,
                scheduled_tokens=eng.tokens_scheduled, padded_tokens=eng.tokens_padded,
                graph_replays=p.replays,
                decode_launches_in_replays=p.replayed[0],
                prefill_launches_in_replays=p.replayed[1],
                eager_dispatches=p.eager_runs, graph_captures=p.captures,
                run_ahead_dispatches=eng.run_ahead_dispatches,
                run_ahead_tokens=eng.run_ahead_tokens, host_stage_ns=eng.host_stage_ns,
                readback_ns=eng.readback_ns, h2d_bytes=eng.h2d_bytes,
                steady_dispatches=eng.steady_dispatches,
                steady_stage_bytes=eng.steady_stage_bytes,
                steady_clean_dispatches=eng.steady_clean_dispatches,
                steady_h2d_bytes=eng.steady_h2d_bytes)


def warm_run(torch, eng, prompts, phase: str) -> float:
    """The warm-up run of a serving phase; its wall seconds."""
    t0 = time.perf_counter()
    out = run(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    if any(len(v) != MAX_NEW for v in out.values()):
        raise AssertionError(f"{phase} warm-up run: a request did not return 48 tokens")
    return time.perf_counter() - t0


def measured_run(torch, pa, eng, prompts):
    """A serving phase's measured run, with every count zeroed just before
    it and read just after: (tokens by request, wall seconds, kernel
    launches, plain-version calls, the engine counters' change, power)."""
    before = engine_counters(eng)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_counts()
    sampler = PowerSampler()
    try:
        t0 = time.perf_counter()
        out = run(eng, prompts, MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        power = sampler.stop()
    launches, plain_calls = launch_counts(pa)
    d = {k: v - before[k] for k, v in engine_counters(eng).items()}
    return out, wall, launches, plain_calls, d, power


def serving_gates(phase: str, out: dict, vocab: int, eng, launches: dict,
                  plain_calls: int) -> None:
    """What every device-path serving run must show: 32 requests of 48
    tokens in the vocabulary, both kernels launched, no plain attention and
    no leaked block."""
    if len(out) != N_REQ or any(len(v) != MAX_NEW for v in out.values()):
        raise AssertionError(f"{phase}: a request did not return 48 tokens")
    if any(not 0 <= t < vocab for v in out.values() for t in v):
        raise AssertionError(f"{phase}: a token outside the vocabulary")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{phase}: a kernel of the path was never launched: {launches}")
    if plain_calls:
        raise AssertionError(f"{phase}: plain attention ran {plain_calls} times")
    if eng.allocator.free_blocks != eng.cfg.num_blocks - 1:
        raise AssertionError(f"{phase}: KV blocks leaked")


def engine_device_phase(torch, np, llama, ragged, pa, host_run: dict):
    """The serving workload on the reference's default path: device-resident
    state, decode run-ahead 48, decode-only programs replayed as CUDA graphs.
    A warm-up run (it captures the graphs), then the measured run with every
    count zeroed just before it, then a profiled run. Returns the measured
    run's kernel launches and the engine (parity_device reads its model)."""
    cfg = llama.LlamaConfig.llama3_8b()
    rcfg = ragged.RaggedConfig(**ENGINE, device_state=True, decode_run_ahead=RUN_AHEAD)
    t0 = time.perf_counter()
    eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = requests(np, cfg.vocab_size)
    warm_s = warm_run(torch, eng, prompts, "engine_device")
    out, wall, launches, plain_calls, d, power = measured_run(torch, pa, eng, prompts)
    gen = sum(len(v) for v in out.values())
    # every request's first token comes from its prompt-completing step
    decode_tokens = gen - len(out)
    emit("engine_device", path=f"device-resident, run-ahead {RUN_AHEAD}, CUDA graphs",
         requests=len(out), new_tokens_each=MAX_NEW, generated_tokens=gen, wall_s=wall,
         generated_tokens_per_s=gen / wall, warmup_wall_s=warm_s, init_s=init_s,
         steps=d["steps"], forwards=d["forwards"], graph_replays=d["graph_replays"],
         eager_dispatches=d["eager_dispatches"], graph_captures=d["graph_captures"],
         kernel_launches_in_replays={"paged_decode": d["decode_launches_in_replays"],
                                     "paged_prefill": d["prefill_launches_in_replays"]},
         graphs=eng.programs.graphs, run_ahead_dispatches=d["run_ahead_dispatches"],
         run_ahead_tokens=d["run_ahead_tokens"],
         run_ahead_share_of_decode_tokens=d["run_ahead_tokens"] / decode_tokens,
         host_stage_s=d["host_stage_ns"] / 1e9, readback_s=d["readback_ns"] / 1e9,
         h2d_bytes=d["h2d_bytes"], steady_dispatches=d["steady_dispatches"],
         steady_stage_bytes=d["steady_stage_bytes"],
         steady_clean_dispatches=d["steady_clean_dispatches"],
         steady_h2d_bytes=d["steady_h2d_bytes"], kernel_launches=launches,
         plain_version_calls=plain_calls, free_blocks=eng.allocator.free_blocks,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         host_staged_max_memory_allocated_bytes=host_run["max_memory_allocated_bytes"],
         host_staged_generated_tokens_per_s=host_run["generated_tokens_per_s"],
         nvidia_smi=nvidia_smi("name", "power.limit"), **power)
    serving_gates("engine_device", out, cfg.vocab_size, eng, launches, plain_calls)
    # steady decode: decode-only dispatches over the previous one's batch
    # stage nothing, and those with no dirty table row upload nothing at all
    if (d["steady_clean_dispatches"] <= 0 or d["steady_stage_bytes"]
            or d["steady_h2d_bytes"]):
        raise AssertionError(
            f"engine_device: steady decode staged {d['steady_stage_bytes']} bytes over "
            f"{d['steady_dispatches']} dispatches, and uploaded {d['steady_h2d_bytes']} "
            f"over the {d['steady_clean_dispatches']} with no dirty table row")
    if d["graph_replays"] <= 0:
        raise AssertionError("engine_device: no CUDA graph was replayed")
    profile_phase(torch, lambda: run(eng, prompts, MAX_NEW), phase="profile_device",
                  cross_check=True)
    return launches, eng, dict(generated_tokens_per_s=gen / wall, forwards=d["forwards"])


def graph_vs_eager(torch, np, llama, eng) -> dict:
    """One decode step of 32 tokens over the 32-layer bf16 model: captured
    as a CUDA graph (``ProgramCache``) and replayed, against
    ``llama.ragged_forward`` called eagerly on the same inputs and its own
    copy of the cache. The 32 sequences own the pool's 576 blocks between
    them (a permutation), so no two tokens write one KV row."""
    from deepspeed_tpu_torch.inference.cuda_graphs import ProgramCache

    cfg = eng.spec.config
    rcfg = eng.cfg
    rng = np.random.default_rng(5)
    t = rcfg.max_seqs
    bt = np.zeros((t + 1, rcfg.max_blocks_per_seq), np.int32)
    bt[:t] = rng.permutation(np.arange(1, rcfg.num_blocks)).reshape(t, -1)
    i32 = dict(dtype=torch.int32, device="cuda")
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, t), **i32)
    slots = torch.arange(t, **i32)
    positions = torch.tensor(rng.integers(0, rcfg.max_seq_len, t), **i32)
    bt = torch.tensor(bt, **i32)

    def cache_copy():
        return {k: (v.clone() if k in ("k", "v") else v) for k, v in eng.cache.items()}

    cache_g = cache_copy()
    programs = ProgramCache("cuda")
    for _ in range(3):  # eager on the side stream and captured, then replayed twice
        got = programs.run("decode_step", lambda: llama.ragged_forward(
            cfg, eng.params, tokens, slots, positions, bt, cache_g)[0])
    want, _ = llama.ragged_forward(cfg, eng.params, tokens, slots, positions, bt,
                                   cache_copy())
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits in the graph or eager decode step")
    return dict(tokens=t, layers=cfg.num_layers, graph_replays=programs.replays,
                bit_identical=bool(torch.equal(got, want)),
                rel_frobenius_err=((got - want).norm() / want.norm()).item(),
                max_abs_err=(got - want).abs().max().item(),
                top1_identical=bool(torch.equal(got.argmax(-1), want.argmax(-1))))


SCHED_PARITY = (("device_sched", dict(device_state=True, sched_steps=SCHED_STEPS)),
                ("device_spec", dict(device_state=True, sched_steps=SCHED_STEPS,
                                     spec_draft=SPEC_DRAFT, spec_ngram=SPEC_NGRAM)),
                ("fused_sched", SCHED), ("fused_spec", SPEC))


def parity_device(torch, np, llama, ragged) -> dict:
    """2 of Llama-3-8B's 32 layers at full width, fp32: greedy tokens of 8
    requests x 48 new tokens through the device-resident engine, without
    and with run-ahead 48, through the fused engine (``FUSED``) on the
    device path and on the host-staged path, and through the scheduler
    engines (``SCHED_PARITY``: the device path and the fused path with
    ``sched_steps`` 16, each without and with ``spec_draft`` 4), against the
    host-staged engine. Each engine serves the requests twice: the first run
    captures each program of the device path at its first dispatch (without
    fused chunks: each decode-only program), the second replays them all."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                               torch.float32, "cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (40, 64, 100, 33, 150, 7, 80, 129)]
    toks, replays, sched = {}, {}, {}
    for name, over in (("host_staged", dict(device_state=False)),
                       ("device", dict(device_state=True)),
                       ("device_run_ahead", dict(device_state=True,
                                                 decode_run_ahead=RUN_AHEAD)),
                       ("fused_device", FUSED),
                       ("fused_host_staged", dict(FUSED, device_state=False)),
                       *SCHED_PARITY):
        eng = ragged.RaggedInferenceEngine(llama.build(cfg), ragged.RaggedConfig(**ENGINE, **over),
                                           dtype=torch.float32, params=params)
        toks[name] = [run(eng, prompts, MAX_NEW) for _ in range(2)]
        replays[name] = eng.programs.replays
        sched[name] = (eng.sched_dispatches, eng.sched_iterations, eng.spec_proposed,
                       eng.spec_accepted)
        del eng
    del params
    torch.cuda.empty_cache()
    want = toks["host_staged"][0]
    return dict(requests=len(prompts), new_tokens_each=MAX_NEW, runs=2, graph_replays=replays,
                host_staged_runs_identical=toks["host_staged"][1] == want,
                device_tokens_identical=all(t == want for t in toks["device"]),
                run_ahead_tokens_identical=all(t == want for t in toks["device_run_ahead"]),
                fused_device_tokens_identical=all(t == want for t in toks["fused_device"]),
                fused_host_staged_tokens_identical=all(
                    t == want for t in toks["fused_host_staged"]),
                sched={name: dict(tokens_identical=all(t == want for t in toks[name]),
                                  graph_replays=replays[name], sched_dispatches=sched[name][0],
                                  sched_iterations=sched[name][1], spec_proposed=sched[name][2],
                                  spec_accepted=sched[name][3])
                       for name, _ in SCHED_PARITY})


GRAPH_REL_FRO = 1e-3


def parity_device_phase(torch, np, llama, ragged, eng) -> None:
    res = parity_device(torch, np, llama, ragged)
    sched = res.pop("sched")
    emit("parity_device_fp32", model="llama3_8b widths", layers=2,
         reduced="depth 32 -> 2 layers", **res)
    emit("parity_sched_fp32", model="llama3_8b widths", layers=2,
         reduced="depth 32 -> 2 layers", requests=res["requests"],
         new_tokens_each=MAX_NEW, runs=2, engines=sched)
    if not all(v["tokens_identical"] and v["sched_dispatches"] > 0 and v["graph_replays"] > 0
               for v in sched.values()):
        raise AssertionError(f"parity_sched: fp32 greedy tokens of a scheduler engine differ "
                             f"from the host-staged engine's, or it ran no scheduler program "
                             f"or no graph: {sched}")
    g = graph_vs_eager(torch, np, llama, eng)
    emit("parity_device_graph_bf16", model="llama3_8b", **g, rel_frobenius_bound=GRAPH_REL_FRO)
    if not (res["device_tokens_identical"] and res["run_ahead_tokens_identical"]
            and res["host_staged_runs_identical"] and res["fused_device_tokens_identical"]
            and res["fused_host_staged_tokens_identical"]):
        raise AssertionError(f"parity_device: fp32 greedy tokens differ from the host-staged "
                             f"engine's: {res}")
    if min(res["graph_replays"][name] for name in ("device", "device_run_ahead",
                                                   "fused_device")) <= 0:
        raise AssertionError(f"parity_device: a device engine replayed no graph: {res}")
    if not (g["rel_frobenius_err"] <= GRAPH_REL_FRO and g["top1_identical"]):
        raise AssertionError(f"parity_device: the replayed graph's logits are outside "
                             f"{GRAPH_REL_FRO} or its top-1 differs: {g}")


# ------------------------------------------------------------ fused chunks
def engine_fused_phase(torch, np, llama, ragged, pa, device_run: dict):
    """The serving workload on the reference bench's own configuration:
    ENGINE with run-ahead 48, fused chunks of 16 and three in flight. After
    ``warmup()`` (which captures the fused program family) a warm-up run,
    the measured run with every count zeroed just before it, then a
    profiled run. Returns the measured run's launches (in all, and inside
    graph replays) and the engine (the fused program check reads its
    model)."""
    cfg = llama.LlamaConfig.llama3_8b()
    rcfg = ragged.RaggedConfig(**ENGINE, **FUSED)
    t0 = time.perf_counter()
    eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    programs = eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = dict(warmup_programs=programs, warmup_s=warmup_s, warmup_graphs=eng.programs.graphs,
                warmup_captures=eng.programs.captures,
                warmup_peak_bytes_above_engine=torch.cuda.max_memory_allocated() - mem0,
                graph_pool_reserved_bytes=torch.cuda.memory_reserved() - reserved0)
    prompts = requests(np, cfg.vocab_size)
    warm_s = warm_run(torch, eng, prompts, "engine_fused")
    out, wall, launches, plain_calls, d, power = measured_run(torch, pa, eng, prompts)
    in_replays = {"paged_decode": d["decode_launches_in_replays"],
                  "paged_prefill": d["prefill_launches_in_replays"]}
    schedule = (d["steps"], d["scheduled_tokens"], d["padded_tokens"])
    gen = sum(len(v) for v in out.values())
    emit("engine_fused", path=f"device-resident, fused chunks of {FUSED_CHUNK}, "
                              f"pipeline depth {PIPELINE_DEPTH}, CUDA graphs",
         requests=len(out), new_tokens_each=MAX_NEW, generated_tokens=gen, wall_s=wall,
         generated_tokens_per_s=gen / wall, warmup_wall_s=warm_s, init_s=init_s, **warm,
         pipeline_depth=PIPELINE_DEPTH, fused_chunk=FUSED_CHUNK,
         steps=d["steps"], forwards=d["forwards"], scheduled_tokens=d["scheduled_tokens"],
         padded_tokens=d["padded_tokens"], jax_schedule=list(FUSED_SCHEDULE),
         graph_replays=d["graph_replays"], eager_dispatches=d["eager_dispatches"],
         graph_captures=d["graph_captures"], kernel_launches_in_replays=in_replays,
         graphs=eng.programs.graphs, host_stage_s=d["host_stage_ns"] / 1e9,
         readback_s=d["readback_ns"] / 1e9, h2d_bytes=d["h2d_bytes"],
         steady_dispatches=d["steady_dispatches"], steady_stage_bytes=d["steady_stage_bytes"],
         steady_clean_dispatches=d["steady_clean_dispatches"],
         steady_h2d_bytes=d["steady_h2d_bytes"], kernel_launches=launches,
         plain_version_calls=plain_calls, free_blocks=eng.allocator.free_blocks,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         device_path_generated_tokens_per_s=device_run["generated_tokens_per_s"],
         device_path_forwards=device_run["forwards"],
         nvidia_smi=nvidia_smi("name", "power.limit"), **power)
    serving_gates("engine_fused", out, cfg.vocab_size, eng, launches, plain_calls)
    if programs != FUSED_WARMUP_PROGRAMS:
        raise AssertionError(f"engine_fused: warmup() prepared {programs} programs, the JAX "
                             f"engine's family has {FUSED_WARMUP_PROGRAMS}")
    if d["graph_captures"] or d["eager_dispatches"] or d["graph_replays"] != d["steps"]:
        raise AssertionError(f"engine_fused: after warmup() the measured run captured "
                             f"{d['graph_captures']} and ran {d['eager_dispatches']} programs "
                             f"eagerly ({d['graph_replays']} replays of {d['steps']} dispatches)")
    if min(in_replays.values()) <= 0:
        raise AssertionError(f"engine_fused: a kernel never launched inside a replay: "
                             f"{in_replays}")
    if schedule != FUSED_SCHEDULE:
        raise AssertionError(f"engine_fused: (dispatches, scheduled, padded) {schedule}, the "
                             f"JAX engine's {FUSED_SCHEDULE}")
    profile_phase(torch, lambda: run(eng, prompts, MAX_NEW), phase="profile_fused")
    return launches, in_replays, eng, dict(generated_tokens_per_s=gen / wall,
                                           forwards=d["forwards"], tokens=out)


def fused_program_check(torch, np, eng) -> dict:
    """One mixed fused program of ``eng`` (a fused engine at ENGINE's
    sizes, idle): a decode region of 32 rows (20 live: 10 run all 16 steps,
    5 only 1..15 and freeze, 5 are already at their EOS, ``done0``) and two
    prefill tiles of one 200-token chunk,
    over a pool of random values. The program runs eagerly, then is captured
    in a ``ProgramCache`` and replayed, each from the same state: what a
    correct program fixes must be bit-identical: the live rows' tokens (the
    20 decode columns, the prefill rows' step-0 picks), the KV pool past
    scratch block 0 and every slot row but the scratch row. (Rows on the
    scratch slot, padding, ``done0`` and frozen rows, all write key 0 of
    block 0 at once and read it back, so their own picks differ from run to
    run by design and are discarded.) And the KV it wrote must be exactly
    that of the rows and steps it schedules (a frozen or retired row writes
    only scratch block 0)."""
    from deepspeed_tpu_torch.inference.cuda_graphs import ProgramCache

    rng = np.random.default_rng(7)
    rcfg = eng.cfg
    max_seqs, bs, mb, ct = rcfg.max_seqs, rcfg.block_size, rcfg.max_blocks_per_seq, \
        rcfg.prefill_tile
    k, nd, nt = FUSED_CHUNK, max_seqs, 2
    t = nd + nt * ct
    vocab = eng.spec.config.vocab_size
    # slots 0..19 decode, slot 20 prefills positions 100..299
    bt = np.zeros((max_seqs + 1, mb), np.int32)
    bt[:21] = rng.permutation(np.arange(1, rcfg.num_blocks))[:21 * mb].reshape(21, mb)
    pos0 = rng.integers(0, mb * bs - k, 20)
    feed = rng.integers(0, vocab, 20)
    kind = np.arange(20) % 4  # 1: freezes after 1..15 steps; 2: done0 (no step)
    steps = np.where(kind == 1, rng.integers(1, k, 20), np.where(kind == 2, 0, k))
    tokens = np.zeros(t, np.int32)
    slots = np.full(t, max_seqs, np.int32)
    positions = np.zeros(t, np.int32)
    flags = np.zeros(t, np.int32)
    dec_rem = np.zeros(nd, np.int32)
    eos = np.full(nd, -1, np.int32)
    slots[:20], flags[:20] = np.arange(20), 1
    dec_rem[:20] = np.where(steps == 0, k, steps)
    eos[:20] = np.where(steps == 0, feed, -1)
    take, p0 = 200, 100
    tokens[nd:nd + take] = rng.integers(0, vocab, take)
    slots[nd:nd + take] = 20
    positions[nd:nd + take] = np.arange(p0, p0 + take)
    flags[nd + take - 1] = 2
    tiles = [np.array([20, 20]), np.array([p0, p0 + ct]), np.array([ct, take - ct])]
    staged = torch.tensor(np.concatenate([tokens, slots, positions, flags, dec_rem, eos,
                                          *tiles]).astype(np.int32), device="cuda")
    tok_st, pos_st = eng._dev_state[0], eng._dev_state[1]
    tok_st[:20] = torch.tensor(feed, dtype=torch.int32, device="cuda")
    pos_st[:20] = torch.tensor(pos0, dtype=torch.int32, device="cuda")
    pos_st[20] = p0
    eng._bt_dev.copy_(torch.tensor(bt, device="cuda"))
    for key in ("k", "v"):
        eng.cache[key].copy_(torch.randn_like(eng.cache[key]))
    state = [eng.cache["k"], eng.cache["v"], tok_st, pos_st]
    init = [x.clone() for x in state]

    def restore():
        for x, x0 in zip(state, init):
            x.copy_(x0)

    fn = eng._get_dev_fused(t, k, nd, nt, mb, staged, (False, False, False))
    eager = fn().clone()
    after = [x.clone() for x in state]
    restore()
    programs = ProgramCache("cuda")
    programs.run("fused", fn)  # eager on the capture stream, then captured
    restore()
    replayed = programs.run("fused", fn).clone()
    torch.cuda.synchronize()

    def live(packed):  # the 20 decode columns, then the prefill rows' picks
        return torch.cat([packed[:k * nd].reshape(k, nd)[:, :20].flatten(),
                          packed[k * nd + nd:k * nd + nd + take]])

    top1 = bool(torch.equal(live(eager), live(replayed)))
    identical = top1 and all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in
                             zip(after[:2], state[:2])) and all(
        torch.equal(a[:-1], b[:-1]) for a, b in zip(after[2:], state[2:]))
    # the (block, offset) rows the program may write, besides scratch block 0
    expect = np.zeros((rcfg.num_blocks, bs), bool)
    for j in range(20):
        for p in range(pos0[j], pos0[j] + steps[j]):
            expect[bt[j, p // bs], p % bs] = True
    for p in range(p0, p0 + take):
        expect[bt[20, p // bs], p % bs] = True
    wrote = ((after[0] != init[0]) | (after[1] != init[1])).flatten(3).any(-1).any(0)
    wrote = wrote.cpu().numpy()
    outside = int((wrote & ~expect)[1:].sum())
    missing = int((expect & ~wrote)[1:].sum())
    dec = eager[:k * nd].reshape(k, nd).cpu().numpy()
    sentinels_ok = bool(all((dec[steps[j]:, j] == -1).all() if steps[j] else
                            (dec[:, j] == -1).all() for j in range(20)))
    del init, after
    eng._bt_dev.zero_()
    torch.cuda.empty_cache()
    return dict(tokens=t, k=k, n_dec=20, n_tiles=nt, layers=eng.spec.config.num_layers,
                dtype=str(eng.dtype).split(".")[1], graph_replays=programs.replays,
                bit_identical=identical, top1_identical=top1,
                kv_rows_written_outside_schedule=outside, kv_rows_missing=missing,
                frozen_and_retired_rows_surface_minus_one=sentinels_ok)


def parity_fused_phase(torch, np, eng) -> None:
    g = fused_program_check(torch, np, eng)
    emit("parity_fused_graph_bf16", model="llama3_8b", **g)
    if not (g["bit_identical"] and g["top1_identical"]):
        raise AssertionError(f"parity_fused: the replayed mixed fused graph differs from its "
                             f"eager run: {g}")
    if g["kv_rows_written_outside_schedule"] or g["kv_rows_missing"]:
        raise AssertionError(f"parity_fused: the program's KV writes are not the rows and "
                             f"steps it schedules: {g}")
    if not g["frozen_and_retired_rows_surface_minus_one"]:
        raise AssertionError(f"parity_fused: a frozen or retired row surfaced a token: {g}")


# ----------------------------------------------- the multi-step scheduler
def verify_case(torch, np, dtype, lanes: int = 1 + SPEC_DRAFT):
    """A speculative verify batch at the 8B shapes, as one scheduler
    iteration with ``spec_draft`` = lanes - 1 gives kernel 4: 32 sequences,
    each a slot whose blocks come from a permutation of the pool, fed
    ``lanes`` consecutive positions from a context of 0..570 keys (lane 0 the
    committed step, lanes 1.. the drafts), their K/V written into the pool
    first (``write_kv_paged``), so lane i + 1 attends lane i's key."""
    from deepspeed_tpu_torch.models.paged import write_kv_paged

    rng = np.random.default_rng(4)
    n, max_seqs = 32, 32
    bt = np.zeros((max_seqs + 1, MB), np.int32)
    bt[:n] = rng.permutation(np.arange(1, NB)).reshape(n, MB)
    pos0 = rng.integers(0, MB * BS - lanes, n)
    i32 = dict(dtype=torch.int32, device="cuda")
    slots = torch.tensor(np.repeat(np.arange(n), lanes), **i32)
    pos = torch.tensor((pos0[:, None] + np.arange(lanes)[None, :]).reshape(-1), **i32)
    bt = torch.tensor(bt, **i32)
    t = n * lanes

    def draw(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device="cuda")

    kp, vp = draw(NB, BS, HKV, D), draw(NB, BS, HKV, D)
    write_kv_paged(kp, vp, draw(t, HKV, D), draw(t, HKV, D), slots, pos, bt)
    return draw(t, HQ, D), kp, vp, slots, pos, bt


def verify_phase(torch, np, pa) -> dict:
    """Kernel 4 on a verify batch (``verify_case``) against its plain
    version in fp32 and bf16, within TOL, on a workspace as the engine runs
    it; the split count the wrapper picks there."""
    workspace = pa.DecodeWorkspace("cuda", HQ, HKV, D)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        args = verify_case(torch, np, dtype)
        got = pa.paged_decode_attention(*args, workspace=workspace)
        want = pa.paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        errs[dname] = (got.float() - want.float()).abs().max().item()
        ok = within(torch, got, want, TOL[dname])
        emit("kernel_check", kernel="paged_decode", case="verify_batch", dtype=dname,
             tokens=args[0].shape[0], lanes=1 + SPEC_DRAFT, max_abs_err=errs[dname],
             check=f"|got-want| <= {TOL[dname]} (1+|want|)", tol=TOL[dname], ok=ok,
             splits=pa.decode_splits(args[0].shape[0], HKV, MB,
                                     torch.cuda.get_device_properties(0).multi_processor_count))
        if not ok:
            raise AssertionError(f"paged_decode on a verify batch, {dname}: max_abs_err "
                                 f"{errs[dname]} > {TOL[dname]}")
        del args
    return errs


def engine_sched_phase(torch, np, llama, ragged, pa, fused_run: dict, sched_run=None):
    """The serving workload on the bench's configuration plus the scheduler
    (``SCHED``), or with ``sched_run`` (the scheduler phase's tokens) plus
    self-speculation (``SPEC``): ``warmup()`` (the fused and scheduler
    families), a warm-up run, the measured run with every count zeroed just
    before it, then a profiled run. Returns the measured run's launches, its
    tokens and the engine (the scheduler program check reads its model)."""
    spec = sched_run is not None
    phase = "engine_spec" if spec else "engine_sched"
    cfg = llama.LlamaConfig.llama3_8b()
    rcfg = ragged.RaggedConfig(**ENGINE, **(SPEC if spec else SCHED))
    t0 = time.perf_counter()
    eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    programs = eng.warmup()
    torch.cuda.synchronize()
    warm = dict(warmup_programs=programs, warmup_s=time.perf_counter() - t0,
                warmup_graphs=eng.programs.graphs,
                warmup_peak_bytes_above_engine=torch.cuda.max_memory_allocated() - mem0,
                graph_pool_reserved_bytes=torch.cuda.memory_reserved() - reserved0)
    prompts = requests(np, cfg.vocab_size)
    warm_s = warm_run(torch, eng, prompts, phase)
    sched0 = (eng.sched_dispatches, eng.sched_iterations, eng.spec_proposed, eng.spec_accepted)
    out, wall, launches, plain_calls, d, power = measured_run(torch, pa, eng, prompts)
    n_sched, iters, proposed, accepted = (
        a - b for a, b in zip((eng.sched_dispatches, eng.sched_iterations, eng.spec_proposed,
                               eng.spec_accepted), sched0))
    in_replays = {"paged_decode": d["decode_launches_in_replays"],
                  "paged_prefill": d["prefill_launches_in_replays"]}
    schedule = (d["steps"], d["scheduled_tokens"], d["padded_tokens"])
    gen = sum(len(v) for v in out.values())
    extra = {}
    if spec:
        extra = dict(spec_draft=SPEC_DRAFT, spec_ngram=SPEC_NGRAM, spec_proposed=proposed,
                     spec_accepted=accepted, acceptance_rate=accepted / max(1, proposed),
                     streams_equal_to_engine_sched=sum(out[i] == sched_run[i] for i in out))
    emit(phase, path=f"device-resident, fused chunks of {FUSED_CHUNK}, pipeline depth "
                     f"{PIPELINE_DEPTH}, sched_steps {SCHED_STEPS}"
                     + (f", spec_draft {SPEC_DRAFT}" if spec else "") + ", CUDA graphs",
         requests=len(out), new_tokens_each=MAX_NEW, generated_tokens=gen, wall_s=wall,
         generated_tokens_per_s=gen / wall, warmup_wall_s=warm_s, init_s=init_s, **warm,
         steps=d["steps"], fused_dispatches=d["steps"] - n_sched, sched_dispatches=n_sched,
         forwards=d["forwards"], sched_iterations=iters, tokens_per_forward=gen / d["forwards"],
         scheduled_tokens=d["scheduled_tokens"], padded_tokens=d["padded_tokens"],
         jax_schedule=None if spec else list(SCHED_SCHEDULE),
         graph_replays=d["graph_replays"], eager_dispatches=d["eager_dispatches"],
         graph_captures=d["graph_captures"], kernel_launches_in_replays=in_replays,
         graphs=eng.programs.graphs, host_stage_s=d["host_stage_ns"] / 1e9,
         readback_s=d["readback_ns"] / 1e9, h2d_bytes=d["h2d_bytes"],
         steady_dispatches=d["steady_dispatches"], steady_h2d_bytes=d["steady_h2d_bytes"],
         kernel_launches=launches, plain_version_calls=plain_calls,
         free_blocks=eng.allocator.free_blocks,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         fused_path_generated_tokens_per_s=fused_run["generated_tokens_per_s"],
         fused_path_forwards=fused_run["forwards"], **extra,
         nvidia_smi=nvidia_smi("name", "power.limit"), **power)
    serving_gates(phase, out, cfg.vocab_size, eng, launches, plain_calls)
    if programs != SCHED_WARMUP_PROGRAMS:
        raise AssertionError(f"{phase}: warmup() prepared {programs} programs, the JAX "
                             f"engine's family has {SCHED_WARMUP_PROGRAMS}")
    if d["graph_captures"] or d["eager_dispatches"] or d["graph_replays"] != d["steps"]:
        raise AssertionError(f"{phase}: after warmup() the measured run captured "
                             f"{d['graph_captures']} and ran {d['eager_dispatches']} programs "
                             f"eagerly ({d['graph_replays']} replays of {d['steps']} dispatches)")
    if launches != in_replays or n_sched <= 0:
        raise AssertionError(f"{phase}: kernel launches {launches} not all inside replays "
                             f"({in_replays}), or no scheduler dispatch ({n_sched})")
    if not spec and (schedule != SCHED_SCHEDULE
                     or (d["steps"] - n_sched, n_sched) != SCHED_DISPATCHES):
        raise AssertionError(f"{phase}: (dispatches, scheduled, padded) {schedule}, the JAX "
                             f"engine's {SCHED_SCHEDULE}; (fused, sched) dispatches "
                             f"{(d['steps'] - n_sched, n_sched)}, want {SCHED_DISPATCHES}")
    if spec and proposed <= 0:
        raise AssertionError(f"{phase}: no draft token was proposed")
    profile_phase(torch, lambda: run(eng, prompts, MAX_NEW), phase="profile_" + phase[7:])
    return launches, out, eng, dict(generated_tokens_per_s=gen / wall)


def sched_program_check(torch, np, eng) -> dict:
    """One scheduler program of ``eng`` (a scheduler engine at ENGINE's
    sizes, idle, no drafts) at k = 16 over 32 rows, on a pool of random
    values: every row live, each with its own blocks (a permutation of the
    pool), a random feed token and position; a quarter of the rows with
    budgets of 1..15 steps, the rest 16. An eager probe (no EOS) gives each
    row's picks; then a quarter of the rows take as EOS their own pick at
    step 2 or 3. The program runs eagerly, then is captured in a
    ``ProgramCache`` (its iterations under conditional nodes) and replayed,
    each from the same state: output (tokens, steps taken, iterations), KV
    past scratch block 0 and slot rows but the scratch row must be
    bit-identical, the steps those the probe predicts, the iterations the
    deepest row's steps, and the KV written exactly that of the positions
    fed. Then the early exit: a replay where every row retires by iteration
    3 (EOS at step 1..3) against one with no EOS (16 iterations), each
    timed by CUDA events, and one where every row starts retired (its EOS
    is its token row: 0 iterations)."""
    from deepspeed_tpu_torch.inference.cuda_graphs import ProgramCache

    rng = np.random.default_rng(9)
    rcfg = eng.cfg
    max_seqs, bs, mb = rcfg.max_seqs, rcfg.block_size, rcfg.max_blocks_per_seq
    k, t = SCHED_STEPS, max_seqs
    vocab = eng.spec.config.vocab_size
    bt = np.zeros((max_seqs + 1, mb), np.int32)
    bt[:t] = rng.permutation(np.arange(1, rcfg.num_blocks))[:t * mb].reshape(t, mb)
    pos0 = rng.integers(0, mb * bs - 2 * k, t)
    bud = np.where(np.arange(t) % 4 == 1, rng.integers(1, k, t), k)
    feed = rng.integers(0, vocab, t)
    i32 = dict(dtype=torch.int32, device="cuda")
    staged = torch.tensor(np.concatenate([np.arange(t), np.full(t, -1), pos0 + bud]), **i32)
    tok_st, pos_st = eng._dev_state[0], eng._dev_state[1]
    tok_st[:t] = torch.tensor(feed, **i32)
    pos_st[:t] = torch.tensor(pos0, **i32)
    eng._bt_dev.copy_(torch.tensor(bt, device="cuda"))
    for key in ("k", "v"):
        eng.cache[key].copy_(torch.randn_like(eng.cache[key]))
    state = [eng.cache["k"], eng.cache["v"], tok_st, pos_st]
    init = [x.clone() for x in state]

    def restore(rows_only=False):
        for x, x0 in list(zip(state, init))[2 if rows_only else 0:]:
            x.copy_(x0)

    def set_eos(eos):
        staged[t:2 * t] = torch.tensor(eos, **i32)

    fn = eng._get_dev_sched(k, t, mb, staged, (False, False, False))
    probe = fn()[:k * t].reshape(k, t).cpu().numpy()
    restore()
    eos = np.full(t, -1)
    at = rng.integers(1, 3, t)  # EOS at step 2 or 3
    for j in range(t):
        if j % 4 == 2:
            eos[j] = probe[at[j], j]
    steps = np.array([next((i + 1 for i in range(bud[j]) if probe[i, j] == eos[j]), bud[j])
                      for j in range(t)])
    set_eos(eos)
    eager = fn().clone()
    after = [x.clone() for x in state]
    restore()
    programs = ProgramCache("cuda")
    key = ("sched", k, t, mb, 0, False, False, False)
    programs.run_loop(key, fn)  # eager on the capture stream, then captured
    restore()
    replayed = programs.run_loop(key, fn)[0].clone()
    torch.cuda.synchronize()
    got_steps = replayed[k * t:k * t + t].cpu().numpy()
    iterations = int(replayed[-1])
    identical = bool(torch.equal(eager, replayed)) and all(
        torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(after[:2], state[:2])) and all(
        torch.equal(a[:-1], b[:-1]) for a, b in zip(after[2:], state[2:]))
    expect = np.zeros((rcfg.num_blocks, bs), bool)
    for j in range(t):
        for p in range(pos0[j], pos0[j] + steps[j]):
            expect[bt[j, p // bs], p % bs] = True
    wrote = ((after[0] != init[0]) | (after[1] != init[1])).flatten(3).any(-1).any(0)
    wrote = wrote.cpu().numpy()
    outside = int((wrote & ~expect)[1:].sum())
    missing = int((expect & ~wrote)[1:].sum())
    del after

    def timed(eos_row, reps=10):
        """Mean CUDA-event ms of a replay over the last reps - 2, each
        replay's ms, the host ms of its launch call, and the iterations."""
        set_eos(eos_row)
        ms, host, its = [], [], set()
        for _ in range(reps):
            restore(rows_only=True)
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            h0 = time.perf_counter()
            out, _ = programs.run_loop(key, fn)
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            its.add(int(out[-1]))
        return sum(ms[2:]) / len(ms[2:]), dict(replay_ms=ms, launch_host_ms=host), sorted(its)

    early_eos = np.array([probe[min(int(rng.integers(0, 3)), bud[j] - 1), j] for j in range(t)])
    full_ms, full_reps, full_its = timed(np.full(t, -1))
    early_ms, early_reps, early_its = timed(early_eos)
    retired_ms, retired_reps, retired_its = timed(feed)
    restore()
    del init
    eng._bt_dev.zero_()
    torch.cuda.empty_cache()
    return dict(k=k, rows=t, layers=eng.spec.config.num_layers, dtype=str(eng.dtype).split(".")[1],
                graph_replays=programs.replays, bit_identical=identical,
                steps_as_probed=bool((got_steps == steps).all()),
                iterations=iterations, deepest_row_steps=int(steps.max()),
                kv_rows_written_outside_schedule=outside, kv_rows_missing=missing,
                full_replay_ms=full_ms, full_iterations=full_its,
                early_exit_replay_ms=early_ms, early_exit_iterations=early_its,
                early_to_full=early_ms / full_ms, all_retired_replay_ms=retired_ms,
                all_retired_iterations=retired_its,
                reps=dict(full=full_reps, early_exit=early_reps, all_retired=retired_reps))


def parity_sched_phase(torch, np, eng) -> None:
    g = sched_program_check(torch, np, eng)
    emit("sched_program_check", model="llama3_8b", **g, early_to_full_bound=0.25,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if not (g["bit_identical"] and g["steps_as_probed"]):
        raise AssertionError(f"sched_program_check: the replayed scheduler graph differs from "
                             f"its eager run, or its steps from the probe's: {g}")
    if g["iterations"] != g["deepest_row_steps"]:
        raise AssertionError(f"sched_program_check: {g['iterations']} iterations, the deepest "
                             f"row took {g['deepest_row_steps']} steps: {g}")
    if g["kv_rows_written_outside_schedule"] or g["kv_rows_missing"]:
        raise AssertionError(f"sched_program_check: the program's KV writes are not the "
                             f"positions it fed: {g}")
    if (g["full_iterations"] != [SCHED_STEPS] or max(g["early_exit_iterations"]) > 3
            or g["all_retired_iterations"] != [0] or not g["early_to_full"] < 0.25):
        raise AssertionError(f"sched_program_check: the early exit is not real: {g}")


# ---------------------------------------------------------------- sampling
# sample_tokens' distribution check: a fixed 8-way logit vector, every
# on/off combination of temperature (0.7; off: 1.0), top-k (3) and top-p
# (0.8), 2^18 draws under distinct fold_in keys each
SAMPLE_LOGITS = (2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0)
SAMPLE_DRAWS = 1 << 18
SAMPLE_CONTROLS = (0.7, 3, 0.8)
SAMPLE_Z_LIMIT = 5.0
# keys and shapes of the exact-bits check: 1-D and 2-D, the vocabulary's width
BITS_SEEDS = (0, 7, 0x5A3D1E, 2**31 - 1)
BITS_SHAPES = ((1,), (97,), (128256,), (16, 97), (8, 128256))


def filtered_probs(np, logits, temperature: float, top_k: int, top_p: float):
    """The distribution ``sample_tokens`` draws from, in float64 from the
    definitions: logits / temperature; the ``top_k`` highest kept (0: all);
    then, over what is kept, the smallest prefix of the descending
    distribution whose mass reaches ``top_p`` (1: all)."""
    x = np.asarray(logits, np.float64) / temperature
    order = np.argsort(-x, kind="stable")
    kept = np.zeros(x.size, bool)
    kept[order[:top_k or x.size]] = True
    if top_p < 1.0:
        xs = np.where(kept[order], x[order], -np.inf)
        p = np.exp(xs - xs.max())
        p /= p.sum()
        kept[order[(np.cumsum(p) - p) >= top_p]] = False
    e = np.where(kept, np.exp(x - x[kept].max()), 0.0)
    return e / e.sum()


def sampling_phase(torch, np) -> None:
    """Exact bits: the port's threefry words, ``fold_in`` and uniform floats
    on the card equal the same calls on the CPU (integer work). Then the
    sampler's distribution: every category's share of 2^18 draws within 5
    sigma of its filtered softmax probability, filtered-out ones never
    drawn."""
    from deepspeed_tpu_torch.inference import sampling
    from deepspeed_tpu_torch.utils import prng

    tiny = float(torch.finfo(torch.float32).tiny)
    checked = differ = 0

    def same(a, b):
        nonlocal checked, differ
        checked += 1
        differ += int(not torch.equal(a.cpu(), b))

    t0 = time.perf_counter()
    for seed in BITS_SEEDS:
        kc, kg = prng.prng_key(seed), prng.prng_key(seed, "cuda")
        same(kg, kc)
        for data in (0, 1, 12345, 2**32 - 1):
            same(prng.fold_in(kg, data), prng.fold_in(kc, data))
        rows_c = prng.fold_in(kc, torch.arange(16))
        rows_g = prng.fold_in(kg, torch.arange(16, device="cuda"))
        same(rows_g, rows_c)
        same(prng.random_bits(rows_g, (97,)), prng.random_bits(rows_c, (97,)))
        for shape in BITS_SHAPES:
            same(prng.random_bits(kg, shape), prng.random_bits(kc, shape))
            for lo in (0.0, tiny):
                same(prng.uniform(kg, shape, lo, 1.0).view(torch.int32),
                     prng.uniform(kc, shape, lo, 1.0).view(torch.int32))
    torch.cuda.synchronize()
    bits_s = time.perf_counter() - t0

    n, logits = SAMPLE_DRAWS, torch.tensor(SAMPLE_LOGITS, device="cuda")
    temp_on, k_on, p_on = SAMPLE_CONTROLS
    root = prng.prng_key(0x5A3D1E, "cuda")
    cases, z_max = [], 0.0
    for combo in range(8):
        temp = temp_on if combo & 1 else 1.0
        top_k = k_on if combo & 2 else 0
        top_p = p_on if combo & 4 else 1.0
        keys = prng.fold_in(prng.fold_in(root, combo), torch.arange(n, device="cuda"))
        toks, _ = sampling.sample_tokens(logits.expand(n, -1), keys, temp,
                                         top_k=top_k or None, top_p=top_p if top_p < 1 else None)
        counts = torch.bincount(toks.long(), minlength=logits.numel()).cpu().numpy()
        p = filtered_probs(np, SAMPLE_LOGITS, temp, top_k, top_p)
        live = p > 0
        z = (counts[live] - n * p[live]) / np.sqrt(n * p[live] * (1 - p[live]))
        z_case = float(np.abs(z).max())
        z_max = max(z_max, z_case)
        cases.append(dict(temperature=temp, top_k=top_k, top_p=top_p, counts=counts.tolist(),
                          probs=p.tolist(), max_abs_z=z_case,
                          filtered_out_drawn=int(counts[~live].sum())))
    emit("sampling", exact_bits_checks=checked, exact_bits_differ=differ, exact_bits_s=bits_s,
         bits_seeds=list(BITS_SEEDS), bits_shapes=[list(s) for s in BITS_SHAPES],
         draws_per_case=n, logits=list(SAMPLE_LOGITS), cases=cases, max_abs_z=z_max,
         z_limit=SAMPLE_Z_LIMIT)
    if differ:
        raise AssertionError(f"sampling: {differ} of {checked} threefry results on the card "
                             f"differ from the CPU's")
    if z_max > SAMPLE_Z_LIMIT or any(c["filtered_out_drawn"] for c in cases):
        raise AssertionError(f"sampling: a category's share is beyond {SAMPLE_Z_LIMIT} sigma "
                             f"(max |z| {z_max}) or a filtered-out token was drawn: {cases}")


# ------------------------------------------------------ the serve trial
# bench.py:serve_trial_main's accelerator branch: 32 requests of
# 64/128/256/512-token prompts (the workload of the serving phases), 48 new
# tokens, the dense baseline in padded batches of max_seqs (32) at the
# longest prompt, the naive one a request at a time, then arrivals every
# 0.15 s (bench.py:390)
MAX_PROMPT = max(PROMPT_LENS)
STAGGER_S = 0.15
# streams of the bf16 dense engine's first batch (of 32) whose replayed
# graphs may pick otherwise than its eager run (PERF.md §2); fp32: none
DENSE_BF16_STREAMS_DIFFER = 2


def pad_batch(np, prompts):
    """Prompts left-aligned in a [len, MAX_PROMPT] batch (bench.py:347)."""
    out = np.zeros((len(prompts), MAX_PROMPT), np.int32)
    for i, p in enumerate(prompts):
        out[i, :len(p)] = p
    return out


def dense_graph_vs_eager(torch, dense, batch, max_new: int):
    """The dense engine's tokens for ``batch`` through its replayed graphs
    and the same call run eagerly (no graph): (graph tokens, eager tokens,
    streams that differ)."""
    graph = dense.generate(batch, max_new_tokens=max_new)
    dense.programs.on_card = False
    try:
        eager = dense.generate(batch, max_new_tokens=max_new)
    finally:
        dense.programs.on_card = True
    return graph, eager, int((graph != eager).any(axis=1).sum())


def serve_trial_phase(torch, np, llama, engine_mod, rag, params32) -> None:
    """``bench.py:serve_trial_main`` on the card: ``rag``, engine_fused's
    engine (ENGINE with the bench's fused configuration, after ``warmup()``),
    against the dense engine on its weights (padded batches, and one request
    at a time), then under staggered arrivals. The bench's counts are taken
    from here on."""
    cfg = llama.LlamaConfig.llama3_8b()
    spec = llama.build(cfg)
    max_seqs = ENGINE["max_seqs"]
    sched0, padded0 = rag.tokens_scheduled + rag.tokens_padded, rag.tokens_padded
    prompts = requests(np, cfg.vocab_size)
    useful = sum(len(p) for p in prompts) + N_REQ * MAX_NEW

    def run_ragged():
        out = run(rag, prompts, MAX_NEW)
        if any(len(v) != MAX_NEW for v in out.values()):
            raise AssertionError("serve_trial: a ragged request did not return 48 tokens")
        torch.cuda.synchronize()

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run_ragged()
    ragged_s = timed(run_ragged)
    dense = engine_mod.InferenceEngine(spec, dtype=torch.bfloat16, params=rag.params)
    captures = {}

    def run_dense():
        for i in range(0, N_REQ, max_seqs):
            dense.generate(pad_batch(np, prompts[i:i + max_seqs]), max_new_tokens=MAX_NEW)

    def run_naive():
        for p in prompts:
            dense.generate(pad_batch(np, [p]), max_new_tokens=MAX_NEW)

    run_dense()  # captures the (32, 512, 48) programs
    c0 = dense.programs.captures
    dense_s = timed(run_dense)
    captures["batch"] = dense.programs.captures - c0
    dense.generate(pad_batch(np, [prompts[0]]), max_new_tokens=MAX_NEW)  # captures (1, 512, 48)
    c0 = dense.programs.captures
    naive_s = timed(run_naive)
    captures["naive"] = dense.programs.captures - c0
    sched = rag.tokens_scheduled + rag.tokens_padded - sched0
    padded_two_runs = rag.tokens_padded - padded0

    arrivals = [i * STAGGER_S for i in range(N_REQ)]

    def run_ragged_staggered(tag):
        lat = {}
        t0 = time.perf_counter()
        nxt = 0
        while nxt < N_REQ or rag.has_work:
            now = time.perf_counter() - t0
            while nxt < N_REQ and arrivals[nxt] <= now:
                rag.put((tag, nxt), prompts[nxt], max_new_tokens=MAX_NEW)
                nxt += 1
            if rag.has_work:
                done_before = rag.finished_uids
                rag.step()
                for uid in rag.finished_uids - done_before:
                    lat[uid] = (time.perf_counter() - t0) - arrivals[uid[1]]
            elif nxt < N_REQ:
                time.sleep(max(0.0, arrivals[nxt] - (time.perf_counter() - t0)))
        return lat

    def run_dense_staggered():
        lat = {}
        t0 = time.perf_counter()
        nxt = 0
        while nxt < N_REQ:
            now = time.perf_counter() - t0
            if arrivals[nxt] > now:
                time.sleep(arrivals[nxt] - now)
            now = time.perf_counter() - t0
            wave = []
            while nxt < N_REQ and arrivals[nxt] <= now and len(wave) < max_seqs:
                wave.append(nxt)
                nxt += 1
            batch = pad_batch(np, [prompts[i] for i in wave]
                              + [prompts[0]] * (max_seqs - len(wave)))
            dense.generate(batch, max_new_tokens=MAX_NEW)
            fin = time.perf_counter() - t0
            for i in wave:
                lat[i] = fin - arrivals[i]
        return lat

    run_ragged_staggered("w")
    disp0, tok0 = rag.dispatch_count, rag.tokens_emitted
    rag_lat = list(run_ragged_staggered("s").values())
    stag_dispatches = rag.dispatch_count - disp0
    stag_generated = rag.tokens_emitted - tok0
    c0 = dense.programs.captures
    den_lat = list(run_dense_staggered().values())
    captures["staggered"] = dense.programs.captures - c0
    rag_mean, den_mean = sum(rag_lat) / len(rag_lat), sum(den_lat) / len(den_lat)
    first = pad_batch(np, prompts[:max_seqs])
    # where a dense (32, 512, 48) call spends the card's time
    profile_phase(torch, lambda: dense.generate(first, max_new_tokens=MAX_NEW),
                  phase="profile_dense_serve")

    # the dense engine's graphs against its eager run: the first batch,
    # bf16 at full depth, then fp32 at 2 layers
    graph, _, differ_bf16 = dense_graph_vs_eager(torch, dense, first, MAX_NEW)
    dense_programs = dense.programs.graphs
    leaked = rag.allocator.free_blocks != rag.cfg.num_blocks - 1
    # the bench divides the padding of every run, the staggered ones too, by
    # the tokens of the first two (bench.py:420,452)
    padding_frac = (rag.tokens_padded - padded0) / max(sched, 1)
    peak = torch.cuda.max_memory_allocated()
    del dense, rag
    gc.collect()
    torch.cuda.empty_cache()
    dense32 = engine_mod.InferenceEngine(llama.build(params32[0]), dtype=torch.float32,
                                         params=params32[1])
    _, _, differ_fp32 = dense_graph_vs_eager(torch, dense32, first, MAX_NEW)
    fp32_ok = differ_fp32 == 0 and dense32.programs.captures == 2
    del dense32
    gc.collect()
    torch.cuda.empty_cache()
    in_vocab = bool(((graph[:, MAX_PROMPT:] >= 0) & (graph[:, MAX_PROMPT:] < cfg.vocab_size))
                    .all())
    emit("serve_trial", model="llama3_8b", dtype="bfloat16", source="bench.py:252-479",
         ragged_tokens_per_s=useful / ragged_s, dense_tokens_per_s=useful / dense_s,
         naive_tokens_per_s=useful / naive_s, ragged_vs_dense=dense_s / ragged_s,
         ragged_vs_naive=naive_s / ragged_s,
         ragged_padding_frac=padding_frac,
         ragged_padding_frac_of_the_two_runs=padded_two_runs / max(sched, 1),
         staggered_ragged_mean_latency_s=rag_mean, staggered_dense_mean_latency_s=den_mean,
         staggered_latency_ratio=den_mean / rag_mean,
         staggered_dispatches=stag_dispatches,
         staggered_dispatches_per_token=stag_dispatches / max(stag_generated, 1),
         serve_reqs=N_REQ, serve_useful_tokens=useful, serve_max_new=MAX_NEW,
         ragged_s=ragged_s, dense_s=dense_s, naive_s=naive_s, stagger_interval_s=STAGGER_S,
         dense_captures_on_repeat=captures, dense_programs=dense_programs,
         dense_bf16_streams_differ_from_eager=differ_bf16,
         dense_bf16_streams_differ_limit=DENSE_BF16_STREAMS_DIFFER,
         dense_fp32_2_layers_identical_to_eager=fp32_ok,
         max_memory_allocated_bytes=peak, nvidia_smi=nvidia_smi("name", "power.limit"))
    if any(captures.values()):
        raise AssertionError(f"serve_trial: a repeated dense shape captured again: {captures}")
    if not in_vocab:
        raise AssertionError("serve_trial: a dense token outside the vocabulary")
    if differ_bf16 > DENSE_BF16_STREAMS_DIFFER or not fp32_ok:
        raise AssertionError(f"serve_trial: dense graphs vs eager: {differ_bf16} bf16 streams "
                             f"differ (limit {DENSE_BF16_STREAMS_DIFFER}), fp32 identical "
                             f"{fp32_ok}")
    if len(rag_lat) != N_REQ or len(den_lat) != N_REQ:
        raise AssertionError("serve_trial: a staggered request did not finish")
    if leaked:
        raise AssertionError("serve_trial: KV blocks leaked")


# ----------------------------------------------------- steady decode
# bench.py:decode_steady_main's accelerator branch (:505-512): 16 requests,
# 64-token prompts, 96 new tokens; max_seqs 16, budget 256, blocks of 32,
# run-ahead 32, fused chunks of 16 three deep, tiles of 64; the scheduler at
# 16 steps, the staggered economy run at 128 steps and 190 new tokens
STEADY = dict(n_req=16, prompt_len=64, max_new=96, max_seqs=16, budget=256, block=32,
              ahead=32, fused=16, depth=3, tile=64, sched_k=16, econ_k=128, econ_new=190)
STEADY_MODES = {"plain": dict(decode_run_ahead=0, prefill_tile=0, fused_chunk=0),
                "tiled": dict(decode_run_ahead=0, fused_chunk=0),
                "run_ahead": dict(prefill_tile=0, fused_chunk=0),
                "fused": {}}


def steady_build(ragged, spec, dtype, params, device_state: bool, **over):
    s = STEADY
    mbs = -(-(s["prompt_len"] + s["max_new"]) // s["block"])
    kw = dict(max_tokens_per_step=s["budget"], max_seqs=s["max_seqs"], block_size=s["block"],
              num_blocks=s["max_seqs"] * mbs + 1, max_blocks_per_seq=mbs,
              decode_run_ahead=s["ahead"], prefill_tile=s["tile"], fused_chunk=s["fused"],
              pipeline_depth=s["depth"], device_state=device_state)
    kw.update(over)
    return ragged.RaggedInferenceEngine(spec, ragged.RaggedConfig(**kw), dtype=dtype,
                                        params=params, seed=0)


def parity_run(eng, prompts):
    """bench.py:582-587: three prompts, the first greedy, the others seeded
    (7 + i) at temperature 0.9, top-k 20, top-p 0.9; 6 tokens each."""
    for i, p in enumerate(prompts[:3]):
        kw = {} if i == 0 else dict(temperature=0.9, top_k=20, top_p=0.9, seed=7 + i)
        eng.put(i, p, max_new_tokens=6, **kw)
    return eng.generate_all()


def parity_matrix(ragged, spec, dtype, params, prompts):
    """bench.py:589-602: in each dispatch mode, the device path, the
    scheduler and the scheduler with speculation against the host-staged
    streams: (streams equal to host-staged, of 3) by mode and variant."""
    k = STEADY["sched_k"]
    res = {}
    for name, over in STEADY_MODES.items():
        base = parity_run(steady_build(ragged, spec, dtype, params, False, **over), prompts)
        res[name] = {}
        for variant, extra in (("device", {}), ("sched", dict(sched_steps=k)),
                               ("spec", dict(sched_steps=k, spec_draft=4))):
            got = parity_run(steady_build(ragged, spec, dtype, params, True, **over, **extra),
                             prompts)
            res[name][variant] = sum(got[i] == base[i] for i in base)
    gc.collect()
    return res


def decode_steady_phase(torch, np, llama, ragged, engine_mod, pa, weights, params32) -> dict:
    """``bench.py:decode_steady_main`` on the card, on the slice's Llama-3-8B
    (``weights``): the device path, the host-staged path and the scheduler
    on the steady workload, the dense engine on the same batch, the parity
    matrix (gated in fp32 at 2 layers, ``params32``; reported in bf16 at
    full depth), speculation on a repetitive prompt and the dispatch economy
    of a staggered run. Returns the scheduler run's kernel launches."""
    s = STEADY
    cfg = llama.LlamaConfig.llama3_8b()
    spec = llama.build(cfg)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (s["prompt_len"],), dtype=np.int32)
               for _ in range(s["n_req"])]

    def run_tagged(eng, tag):
        for i, p in enumerate(prompts):
            eng.put((tag, i), p, max_new_tokens=s["max_new"])
        out = eng.generate_all()
        torch.cuda.synchronize()
        return out

    def measure(device_state, **over):
        """bench.py:538-560: a warm-up run, then the measured run with the
        dispatch-overhead meters and the launch counts zeroed just before
        it. Returns (the bench's stats, tokens by request, kernel launches,
        plain-version calls, whether a stream, a token or the pool is
        wrong)."""
        eng = steady_build(ragged, spec, bf16, weights, device_state, **over)
        run_tagged(eng, "warm")
        eng.host_stage_ns = eng.readback_ns = eng.h2d_bytes = 0
        d0 = eng.dispatch_count
        pa.reset_counts()
        t0 = time.perf_counter()
        out = run_tagged(eng, "run")
        dt = time.perf_counter() - t0
        launches, plain = launch_counts(pa)
        disp = max(eng.dispatch_count - d0, 1)
        toks = sum(len(v) for v in out.values())
        bad = (any(len(v) != s["max_new"] or not all(0 <= t < cfg.vocab_size for t in v)
                   for v in out.values())
               or eng.allocator.free_blocks != eng.cfg.num_blocks - 1)
        stats = {"tokens_per_s": toks / dt,
                 "host_stage_ms_per_step": eng.host_stage_ns / disp / 1e6,
                 "readback_ms_per_step": eng.readback_ns / disp / 1e6,
                 "h2d_bytes_per_step": eng.h2d_bytes / disp, "dispatches": disp, "wall_s": dt,
                 "graph_replays": eng.programs.replays, "graph_captures": eng.programs.captures}
        del eng
        gc.collect()
        return stats, {uid[1]: v for uid, v in out.items()}, launches, plain, bad

    results, outs, checks = {}, {}, {}
    for name, ds, over in (("dev", True, {}), ("host", False, {}),
                           ("sch", True, dict(sched_steps=s["sched_k"]))):
        results[name], outs[name], *checks[name] = measure(ds, **over)
    sched_launches, sched_plain = checks["sch"][0], checks["sch"][1]

    dense = engine_mod.InferenceEngine(spec, dtype=bf16, params=weights)
    batch = np.stack(prompts)
    dense.generate(batch, max_new_tokens=s["max_new"])  # captures
    c0 = dense.programs.captures
    t0 = time.perf_counter()
    dense.generate(batch, max_new_tokens=s["max_new"])
    dense_tok_s = s["n_req"] * s["max_new"] / (time.perf_counter() - t0)
    dense_recaptures = dense.programs.captures - c0
    del dense
    gc.collect()

    parity32 = parity_matrix(ragged, llama.build(params32[0]), torch.float32, params32[1],
                             prompts)
    parity16 = parity_matrix(ragged, spec, bf16, weights, prompts)

    spec_eng = steady_build(ragged, spec, bf16, weights, True, sched_steps=s["sched_k"],
                            spec_draft=4)
    pat = list(rng.integers(0, cfg.vocab_size, (5,))) * 4
    spec_eng.put("rep", np.asarray(pat, np.int32), max_new_tokens=s["max_new"])
    spec_eng.generate_all()
    spec_prop, spec_acc = spec_eng.spec_proposed, spec_eng.spec_accepted
    del spec_eng

    mbs_econ = -(-(s["prompt_len"] + s["econ_new"]) // s["block"])
    econ = ragged.RaggedInferenceEngine(spec, ragged.RaggedConfig(
        max_tokens_per_step=s["budget"], max_seqs=s["max_seqs"], block_size=s["block"],
        num_blocks=s["max_seqs"] * mbs_econ + 1, max_blocks_per_seq=mbs_econ,
        sched_steps=s["econ_k"]), dtype=bf16, params=weights, seed=0)
    fed, d0, e0 = 0, None, None
    t0 = time.perf_counter()
    for _ in range(100000):
        if fed < s["n_req"]:
            econ.put(fed, prompts[fed], max_new_tokens=s["econ_new"])
            fed += 1
        if not econ.has_work:
            break
        econ.step()
        if (d0 is None and fed == s["n_req"] and not econ._queued
                and all(q.in_decode for q in econ._running.values())):
            d0, e0 = econ.dispatch_count, econ.tokens_emitted
    econ.drain()
    econ_s = time.perf_counter() - t0
    econ_disp = econ.dispatch_count - d0
    econ_toks = max(econ.tokens_emitted - e0, 1)
    econ_captures = econ.programs.captures
    del econ
    gc.collect()
    torch.cuda.empty_cache()

    dev, host, sch = results["dev"], results["host"], results["sch"]
    outputs_match = outs["dev"] == outs["host"] and outs["sch"] == outs["host"]
    emit("decode_steady", model="llama3_8b", dtype="bfloat16", source="bench.py:482-690",
         workload=STEADY,
         steady_ragged_tokens_per_s=sch["tokens_per_s"],
         steady_ragged_no_sched_tokens_per_s=dev["tokens_per_s"],
         steady_host_staged_tokens_per_s=host["tokens_per_s"],
         steady_dense_tokens_per_s=dense_tok_s,
         steady_ragged_vs_dense=sch["tokens_per_s"] / dense_tok_s,
         steady_ragged_vs_dense_no_sched=dev["tokens_per_s"] / dense_tok_s,
         ragged_vs_dense=sch["tokens_per_s"] / dense_tok_s,
         steady_staging_reduction=host["host_stage_ms_per_step"]
         / max(dev["host_stage_ms_per_step"], 1e-9),
         steady_device_state=dev, steady_host_staged=host, steady_sched=sch,
         steady_sched_steps=s["sched_k"],
         steady_dispatches_per_token=sch["dispatches"] / max(s["n_req"] * s["max_new"], 1),
         staggered_dispatches_per_token=econ_disp / econ_toks,
         staggered_econ_dispatches=econ_disp, staggered_econ_tokens=econ_toks,
         staggered_econ_s=econ_s, staggered_econ_captures=econ_captures,
         steady_outputs_match=outputs_match,
         streams_equal_to_host_staged_of_16={
             name: sum(outs[name][i] == outs["host"][i] for i in outs["host"])
             for name in ("dev", "sch")},
         steady_parity={m: v["device"] == 3 for m, v in parity16.items()},
         steady_sched_parity={m: v["sched"] == 3 for m, v in parity16.items()},
         steady_spec_parity={m: v["spec"] == 3 for m, v in parity16.items()},
         parity_bf16_streams_equal_of_3=parity16, parity_fp32_2_layers_streams_equal_of_3=parity32,
         steady_spec_proposed=spec_prop, steady_spec_accepted=spec_acc,
         steady_spec_acceptance_rate=spec_acc / max(spec_prop, 1),
         steady_reqs=s["n_req"], steady_max_new=s["max_new"],
         sched_kernel_launches=sched_launches, sched_plain_version_calls=sched_plain,
         dense_captures_on_repeat=dense_recaptures,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if any(c[2] for c in checks.values()):
        raise AssertionError(f"decode_steady: a run returned a wrong-length stream, a token "
                             f"outside the vocabulary, or leaked blocks: {checks}")
    if not all(v == 3 for modes in parity32.values() for v in modes.values()):
        raise AssertionError(f"decode_steady: fp32 seeded streams of the device, scheduler or "
                             f"speculation path differ from the host-staged ones: {parity32}")
    if min(sched_launches.values()) <= 0 or sched_plain:
        raise AssertionError(f"decode_steady: the scheduler run launched {sched_launches} and "
                             f"called plain attention {sched_plain} times")
    if dense_recaptures:
        raise AssertionError("decode_steady: the dense engine's repeated shape captured again")
    return sched_launches


# ------------------------------------------- prefix cache, KV tiers, handoff
# bench.py:1255-1260's shared-prefix workload at P = 96 tokens (3 blocks of
# 32), so every tail after a hit starts in the middle of a 128-token tile
PREFIX_TOKENS = 96
# the fp32 gate at 2 layers: the four dispatch modes, 16 new tokens a
# request, odd requests seeded as bench.py:1236 seeds them
PREFIX_MODES = {"host": dict(device_state=False),
                "device": dict(device_state=True, decode_run_ahead=RUN_AHEAD),
                "fused": FUSED, "spec": SPEC}
PREFIX_FP32_NEW = 16
SEEDED = dict(temperature=0.9, top_k=20)


def shared_prefix_prompts(np, vocab, rng, prefix):
    """``prefix`` + max(1, L - P) fresh tokens for L in PROMPT_LENS, N_REQ
    prompts shuffled by ``rng`` (bench.py:1255-1260)."""
    prompts = [np.concatenate([prefix, rng.integers(
        0, vocab, (max(1, PROMPT_LENS[i % len(PROMPT_LENS)] - len(prefix)),), dtype=np.int32)])
        for i in range(N_REQ)]
    rng.shuffle(prompts)
    return prompts


def tagged_run(torch, eng, prompts, tag, max_new=MAX_NEW, seeded=False):
    """Put ``prompts`` as uids (tag, i), odd ones seeded (1000 + i) when
    ``seeded``; tokens by i."""
    for i, p in enumerate(prompts):
        kw = dict(SEEDED, seed=1000 + i) if seeded and i % 2 else {}
        eng.put((tag, i), p, max_new_tokens=max_new, **kw)
    out = eng.generate_all()
    torch.cuda.synchronize()
    return {uid[1]: v for uid, v in out.items() if uid[0] == tag}


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def divergence(got: dict, want: dict) -> list:
    """For each stream of ``got`` that differs from ``want``'s, the index of
    its first differing token, sorted."""
    return sorted(next(i for i, (a, b) in enumerate(zip(got[k] + [None], want[k] + [None]))
                       if a != b) for k in want if got[k] != want[k])


def pool_clean(eng) -> bool:
    """No reference held and every usable block free or retained."""
    alloc = eng.allocator
    return (all(r == 0 for r in alloc._refs) and not eng._reserved
            and len(alloc._free) + alloc.retained_blocks == alloc.num_blocks - 1)


def prefix_cache_phase(torch, np, llama, ragged, pa, weights, params32) -> dict:
    """The reference bench's serving configuration (``ENGINE`` + ``FUSED``)
    with ``enable_prefix_cache`` after ``warmup()``, on the shared-prefix
    workload: run A cold, run B the same prefix with fresh tails (every
    request splices the prefix's 3 blocks), run C B's prompts again (every
    request splices all but its last block). Each run's counts are zeroed
    just before it and read just after. Then the fp32 gate at 2 layers: in
    each dispatch mode, hit tokens (greedy and seeded) equal a cold
    engine's. Returns the launches of runs A + B + C."""
    cfg = llama.LlamaConfig.llama3_8b()
    spec = llama.build(cfg)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (PREFIX_TOKENS,), dtype=np.int32)
    prompts_a = shared_prefix_prompts(np, cfg.vocab_size, rng, prefix)
    prompts_b = shared_prefix_prompts(np, cfg.vocab_size, rng, prefix)
    bs = ENGINE["block_size"]
    eng = ragged.RaggedInferenceEngine(
        spec, ragged.RaggedConfig(**ENGINE, **FUSED, enable_prefix_cache=True),
        dtype=torch.bfloat16, params=weights)
    t0 = time.perf_counter()
    programs = eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    want = {"A": (0, 0), "B": (N_REQ, N_REQ * PREFIX_TOKENS),
            "C": (N_REQ, sum((len(p) - 1) // bs * bs for p in prompts_b))}
    runs, tokens, total, failed = {}, {}, {}, []
    for name, prompts in (("A", prompts_a), ("B", prompts_b), ("C", prompts_b)):
        p = eng.programs
        before = (eng.prefix_hits, eng.prefix_misses, eng.prefix_tokens_reused,
                  eng.tokens_scheduled, p.captures, p.eager_runs, p.replays,
                  eng.allocator.evictions)
        pa.reset_counts()
        t0 = time.perf_counter()
        tokens[name] = tagged_run(torch, eng, prompts, name)
        wall = time.perf_counter() - t0
        launches, plain = launch_counts(pa)
        hits, misses, reused, sched, captures, eager, replays, evictions = (
            a - b for a, b in zip((eng.prefix_hits, eng.prefix_misses, eng.prefix_tokens_reused,
                                   eng.tokens_scheduled, p.captures, p.eager_runs, p.replays,
                                   eng.allocator.evictions), before))
        prompt_total = sum(len(x) for x in prompts)
        gen = sum(len(v) for v in tokens[name].values())
        # every request feeds MAX_NEW decode tokens (the last one's pick is
        # dropped at reconcile): the rest of the scheduled tokens are prompt
        runs[name] = dict(wall_s=wall, useful_tokens_per_s=(prompt_total + gen) / wall,
                          prompt_tokens=prompt_total, generated_tokens=gen, prefix_hits=hits,
                          prefix_misses=misses, prefix_tokens_reused=reused,
                          scheduled_prompt_tokens=sched - N_REQ * MAX_NEW,
                          graph_captures=captures, eager_dispatches=eager,
                          graph_replays=replays, evictions=evictions,
                          kernel_launches=launches, plain_version_calls=plain)
        add_counts(total, launches)
        if (hits, reused) != want[name]:
            failed.append(f"run {name}: {hits} hits reusing {reused} tokens, want {want[name]}")
        if sched - N_REQ * MAX_NEW != prompt_total - reused:
            failed.append(f"run {name}: {sched - N_REQ * MAX_NEW} prompt tokens scheduled, "
                          f"want {prompt_total} - {reused}")
        if captures or eager or evictions:
            failed.append(f"run {name}: {captures} captures, {eager} eager programs and "
                          f"{evictions} evictions after warmup()")
        if min(launches.values()) <= 0 or plain:
            failed.append(f"run {name}: launches {launches}, plain calls {plain}")
        if len(tokens[name]) != N_REQ or any(len(v) != MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in v) for v in tokens[name].values()):
            failed.append(f"run {name}: a stream of the wrong length or vocabulary")
    clean = pool_clean(eng)
    retained = eng.allocator.retained_blocks
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at 2 layers: hit tokens against a cold engine's, in every mode
    cfg2, p32 = params32
    spec2 = llama.build(cfg2)
    fp32 = {}
    for mode, over in PREFIX_MODES.items():
        rcfg = dict(ENGINE, **over)
        cold = ragged.RaggedInferenceEngine(spec2, ragged.RaggedConfig(**rcfg),
                                            dtype=torch.float32, params=p32)
        want_b = tagged_run(torch, cold, prompts_b, "B", PREFIX_FP32_NEW, seeded=True)
        warm = ragged.RaggedInferenceEngine(
            spec2, ragged.RaggedConfig(**rcfg, enable_prefix_cache=True),
            dtype=torch.float32, params=p32)
        tagged_run(torch, warm, prompts_a, "A", PREFIX_FP32_NEW, seeded=True)
        got_b = tagged_run(torch, warm, prompts_b, "B", PREFIX_FP32_NEW, seeded=True)
        fp32[mode] = dict(streams_equal_to_cold=sum(got_b[i] == want_b[i] for i in want_b),
                          prefix_hits=warm.prefix_hits)
        del cold, warm
        gc.collect()
    torch.cuda.empty_cache()
    emit("prefix_cache", model="llama3_8b", dtype="bfloat16", source="bench.py:1170-1263",
         shared_prefix_tokens=PREFIX_TOKENS, ragged_config=dict(ENGINE, **FUSED),
         prompt_lens=sorted({len(x) for x in prompts_a}), requests=N_REQ,
         new_tokens_each=MAX_NEW, warmup_programs=programs, warmup_s=warmup_s, runs=runs,
         want_hits_and_reused=want, retained_blocks_after=retained, pool_clean=clean,
         bf16_streams_of_c_differing_from_b=sum(tokens["C"][i] != tokens["B"][i]
                                                for i in tokens["B"]),
         bf16_first_differing_token_of_c_vs_b=divergence(tokens["C"], tokens["B"]),
         fp32_2_layers_hit_vs_cold=fp32, fp32_new_tokens_each=PREFIX_FP32_NEW,
         kernel_launches=total, nvidia_smi=nvidia_smi("name", "power.limit"))
    if not clean:
        failed.append("blocks leaked: free + retained != num_blocks - 1")
    for mode, r in fp32.items():
        if r["streams_equal_to_cold"] != N_REQ or r["prefix_hits"] != N_REQ:
            failed.append(f"fp32 {mode}: {r}")
    if failed:
        raise AssertionError(f"prefix_cache: {failed}")
    return total


# bench.py:1203-1251's --kv-tier workload: a pool of two requests' worth of
# blocks, 3 groups of 64-token prefixes on 512-token prompts, every unique
# prompt twice (odd ones seeded), shuffled by default_rng(0); a request
# arrives every KV_TIER_ARRIVAL_STEPS engine steps (its prefetch kicked as
# EngineLoop.prefetch_prefix would)
KV_TIER_MBS = -(-(max(PROMPT_LENS) + MAX_NEW) // BS)
KV_TIER = dict(num_blocks=2 * KV_TIER_MBS + 1, enable_prefix_cache=True, kv_tier=True,
               kv_tier_host_blocks=4 * KV_TIER_MBS, kv_tier_disk_blocks=8 * KV_TIER_MBS)
KV_TIER_GROUPS, KV_TIER_PREFIX, KV_TIER_REQ = 3, 2 * BS, 24
KV_TIER_ARRIVAL_STEPS = 2


def kv_tier_workload(np, vocab, n_req=KV_TIER_REQ):
    rng = np.random.default_rng(0)
    n_uniq = n_req // 2
    prefixes = [rng.integers(0, vocab, (KV_TIER_PREFIX,), dtype=np.int32)
                for _ in range(KV_TIER_GROUPS)]
    reqs = []
    for u in range(n_uniq):
        p = np.concatenate([prefixes[u % KV_TIER_GROUPS], rng.integers(
            0, vocab, (max(PROMPT_LENS) - KV_TIER_PREFIX,), dtype=np.int32)])
        reqs.append((u, p, {} if u % 2 == 0 else dict(SEEDED, seed=1000 + u)))
    reqs = [reqs[i % n_uniq] for i in range(n_req)]
    rng.shuffle(reqs)
    return reqs


def kv_tier_run(torch, ragged, pa, spec, dtype, params, reqs, directory, quant="off"):
    """One tiered run of ``reqs`` arriving every KV_TIER_ARRIVAL_STEPS steps
    after ``warmup()``: pairs of identical occurrences, tier stats, restore
    ms a block by tier, paged launches, plain and quantized-path calls,
    captures during the run, wall seconds, whether the pool is clean."""
    eng = ragged.RaggedInferenceEngine(
        spec, ragged.RaggedConfig(**{**ENGINE, **FUSED, **KV_TIER, "kv_tier_dir": directory,
                                     "quant": quant}),
        dtype=dtype, params=params)
    t0 = time.perf_counter()
    programs = eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    store = eng._kvtier
    restores = {1: [0, 0.0], 2: [0, 0.0]}  # blocks, seconds of restores reaching tier t
    note = store.note_restored

    def timed(tiers, seconds):
        r = restores[2 if 2 in tiers else 1]
        r[0] += len(tiers)
        r[1] += seconds
        note(tiers, seconds)

    store.note_restored = timed
    pending, uniq, step = list(reqs), {}, 0
    captures0 = eng.programs.captures
    pa.reset_counts()
    t0 = time.perf_counter()
    while pending or eng.has_work:
        if pending and step % KV_TIER_ARRIVAL_STEPS == 0:
            u, p, extra = pending.pop(0)
            eng.tier_prefetch_async(p)
            uniq[len(uniq)] = u
            eng.put(len(uniq) - 1, p, max_new_tokens=MAX_NEW, **extra)
        if eng.has_work:
            eng.step()
        step += 1
    out = eng.generate_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = launch_counts(pa)
    by_u: dict = {}
    for uid, toks in out.items():
        by_u.setdefault(uniq[uid], []).append(toks)
    res = dict(
        requests=len(reqs), pairs_identical=sum(len(v) == 2 and v[0] == v[1]
                                                for v in by_u.values()),
        pairs=len(by_u),
        first_differing_token_of_second_occurrence=divergence(
            {u: v[1] for u, v in by_u.items()}, {u: v[0] for u, v in by_u.items()}),
        tier_stats=eng.kv_tier_stats(), block_bytes=eng._block_bytes(),
        restore_ms_per_block={("host" if t == 1 else "disk"): (s * 1e3 / n if n else None)
                              for t, (n, s) in restores.items()},
        restored_blocks={("host" if t == 1 else "disk"): n for t, (n, _) in restores.items()},
        warmup_programs=programs, warmup_s=warmup_s,
        graph_captures_in_run=eng.programs.captures - captures0, kernel_launches=launches,
        plain_version_calls=plain, quantized_path_calls=quantized_calls(pa), wall_s=wall,
        pool_clean=pool_clean(eng) and all(len(v) == MAX_NEW for v in out.values()))
    store.close()
    del eng
    gc.collect()
    return res


def kv_tier_phase(torch, np, llama, ragged, pa, weights, params32) -> dict:
    """bench.py's --kv-tier workload at Llama-3-8B in bf16 (counted: pairs
    of identical occurrences; gated: demotions, spills, host promotions and
    prefetch hits, no torn file swept) and in fp32 at 2 layers (gated:
    every pair identical; a disk restore passes the cost model there). The
    disk records go under runs/, removed at the end. Returns the bf16
    run's launches."""
    import shutil

    cfg = llama.LlamaConfig.llama3_8b()
    reqs = kv_tier_workload(np, cfg.vocab_size)
    root = os.path.join("runs", f"kvtier-chip-smoke-{os.getpid()}")
    cfg2, p32 = params32
    try:
        out = {}
        for name, spec, dtype, params in (("bf16", llama.build(cfg), torch.bfloat16, weights),
                                          ("fp32_2_layers", llama.build(cfg2), torch.float32,
                                           p32)):
            out[name] = kv_tier_run(torch, ragged, pa, spec, dtype, params, reqs,
                                    os.path.join(root, name))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    bytes_per_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd * 2
    emit("kv_tier", model="llama3_8b", source="bench.py:1203-1251",
         ragged_config=dict(ENGINE, **FUSED, **KV_TIER), requests=KV_TIER_REQ,
         prefix_groups=KV_TIER_GROUPS, prefix_tokens=KV_TIER_PREFIX,
         prompt_tokens=max(PROMPT_LENS), new_tokens_each=MAX_NEW,
         arrival_every_steps=KV_TIER_ARRIVAL_STEPS, kv_bytes_per_token=bytes_per_token,
         kv_block_bytes=bytes_per_token * BS,
         restore_us_per_token_modelled={
             "host": bytes_per_token * 8 / 100e9 * 1e6, "disk": bytes_per_token * 8 / 8e9 * 1e6,
             "prefill": 1e6 / 50000.0},
         runs=out, nvidia_smi=nvidia_smi("name", "power.limit"))
    failed = []
    bf, f32 = out["bf16"], out["fp32_2_layers"]
    st = bf["tier_stats"]
    for key in ("demotions", "spills", "promotions_host", "prefetch_hits"):
        if st[key] <= 0:
            failed.append(f"bf16: {key} = {st[key]}")
    if f32["pairs_identical"] != f32["pairs"]:
        failed.append(f"fp32: {f32['pairs_identical']} of {f32['pairs']} pairs identical")
    for name, r in out.items():
        if r["tier_stats"]["sweep_removed"]:
            failed.append(f"{name}: the start-up sweep removed a torn file")
        if not r["pool_clean"] or min(r["kernel_launches"].values()) <= 0 or \
                r["plain_version_calls"]:
            failed.append(f"{name}: pool clean {r['pool_clean']}, launches "
                          f"{r['kernel_launches']}, plain calls {r['plain_version_calls']}")
    if failed:
        raise AssertionError(f"kv_tier: {failed}")
    return bf["kernel_launches"]


def handoff_split(torch, ragged, pa, spec, dtype, params, prompts, quant="off"):
    """The workload through a prefill engine (``put(handoff=True)``) and a
    fused decode engine that shares its weights: each record exported,
    through ``to_bytes`` / ``from_bytes``, imported. Returns (tokens,
    stats, launches, plain calls)."""
    rcfg = ragged.RaggedConfig(**ENGINE, **FUSED, quant=quant)
    pre = ragged.RaggedInferenceEngine(spec, rcfg, dtype=dtype, params=params)
    dec = ragged.RaggedInferenceEngine(spec, rcfg, dtype=dtype, params=params)
    pa.reset_counts()
    for i, p in enumerate(prompts):
        pre.put(i, p, max_new_tokens=MAX_NEW, handoff=True)
    pre.generate_all()
    torch.cuda.synchronize()
    export_s = import_s = 0.0
    nbytes, wire = {}, {}
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        buf = pre.export_handoff(i).to_bytes()
        t1 = time.perf_counter()
        rec = ragged.KVHandoff.from_bytes(buf)
        if not dec.import_handoff(rec):
            raise AssertionError(f"handoff: the decode engine refused request {i}")
        torch.cuda.synchronize()
        export_s += t1 - t0
        import_s += time.perf_counter() - t1
        nbytes[len(p)], wire[len(p)] = rec.nbytes, len(buf)
    out = dec.generate_all()
    torch.cuda.synchronize()
    launches, plain = launch_counts(pa)
    stats = dict(export_ms_per_request=export_s * 1e3 / len(prompts),
                 import_ms_per_request=import_s * 1e3 / len(prompts),
                 record_bytes_by_prompt_len=nbytes, serialized_bytes_by_prompt_len=wire,
                 kv_blocks_exported=pre.kv_blocks_exported,
                 kv_blocks_imported=dec.kv_blocks_imported,
                 pools_clean=pool_clean(pre) and pool_clean(dec))
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()
    return out, stats, launches, plain


def handoff_phase(torch, np, llama, ragged, pa, weights, params32, fused_tokens) -> dict:
    """The 32-request workload split across a prefill and a decode engine at
    Llama-3-8B in bf16 (streams differing from engine_fused's counted) and
    in fp32 at 2 layers (gated: equal to a single engine's). Returns the
    bf16 split's launches (prefill and decode engines)."""
    cfg = llama.LlamaConfig.llama3_8b()
    prompts = requests(np, cfg.vocab_size)
    out, stats, launches, plain = handoff_split(torch, ragged, pa, llama.build(cfg),
                                                torch.bfloat16, weights, prompts)
    cfg2, p32 = params32
    spec2 = llama.build(cfg2)
    single = ragged.RaggedInferenceEngine(spec2, ragged.RaggedConfig(**ENGINE, **FUSED),
                                          dtype=torch.float32, params=p32)
    want32 = run(single, prompts, MAX_NEW)
    del single
    out32, stats32, _, plain32 = handoff_split(torch, ragged, pa, spec2, torch.float32, p32,
                                               prompts)
    same32 = sum(out32[i] == want32[i] for i in want32)
    emit("handoff", model="llama3_8b", dtype="bfloat16", requests=N_REQ,
         new_tokens_each=MAX_NEW, ragged_config=dict(ENGINE, **FUSED), **stats,
         bf16_streams_differing_from_engine_fused=sum(out[i] != fused_tokens[i]
                                                      for i in fused_tokens),
         bf16_first_differing_token=divergence(out, fused_tokens),
         fp32_2_layers_streams_equal_to_single_engine=same32, fp32_2_layers=stats32,
         kernel_launches=launches, plain_version_calls=plain,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    failed = []
    if same32 != N_REQ:
        failed.append(f"fp32: {same32} of {N_REQ} streams equal to a single engine's")
    for name, s in (("bf16", stats), ("fp32", stats32)):
        if s["kv_blocks_exported"] != s["kv_blocks_imported"] or not s["pools_clean"]:
            failed.append(f"{name}: {s}")
    if len(out) != N_REQ or any(len(v) != MAX_NEW for v in out.values()):
        failed.append("bf16: a stream of the wrong length")
    if min(launches.values()) <= 0 or plain or plain32:
        failed.append(f"launches {launches}, plain calls {plain} / {plain32}")
    if failed:
        raise AssertionError(f"handoff: {failed}")
    return launches

# --------------------------------------------------------- low-bit serving
# Llama-3-8B's KV block (32 layers, k and v, 32 tokens, 8 KV heads, head dim
# 128): an int8 or fp8 payload and an fp16 scale a row and head, against
# fp16; and its weights in bf16, woq8 and woq4 (blocks of 256, the embedding
# kept bf16)
KV_BLOCK_BYTES = {"quantized": 2 * 32 * BS * HKV * (D + 2), "fp16": 2 * 32 * BS * HKV * D * 2}
WEIGHT_BYTES = {"bf16": 16_060_522_496, "woq8": 8_673_124_352, "woq4": 4_920_795_136}
# bench.py:1381-1414's drift probe: the first 3 prompts cut to 32 tokens, 12
# new tokens, 2 slots, the scheduler with speculation, off against the codec
DRIFT_PROBE = dict(max_seqs=2, sched_steps=8, spec_draft=4)
DRIFT_PROMPTS, DRIFT_PROMPT_TOKENS, DRIFT_NEW = 3, 32, 12
# the tier round trip and the handoff of quantized payloads, cut down from
# kv_tier's 24 requests and handoff's 32 (the tier run at Llama-3-8B in bf16
# and in fp32 at 2 layers)
KVQ_TIER_REQ, KVQ_HANDOFF_REQ = 12, 8
# the fp32 gate at 2 layers: each path against the host-staged engine
KVQ_PARITY = {"device_run_ahead": dict(device_state=True, decode_run_ahead=RUN_AHEAD),
              "fused": FUSED, "sched": SCHED, "spec": SPEC}


def codec_rows(np, n: int = 512):
    """KV rows at the 8B shapes ([n, 8 KV heads, 128]) over magnitudes
    1e-3..30, with a zero row, a row whose fp16 scale rounds to 0 (0 / 0
    cells), one whose int8 scale is subnormal, and saturating values."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(n, HKV, D)) * rng.uniform(1e-3, 30, size=(n, HKV, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1, 0] = 0.0
    x[1, 0, :6] = [1e-9, 0, -1e-9, 0, 3e-7, 1e-12]
    x[2, 1] = 0.0
    x[2, 1, :3] = [5e-6, -5e-6, 1e-6]
    x[3] = 1e4
    return x


def same_bits(torch, a, b) -> bool:
    """Equal bytes (NaNs included)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


def quant_engine(ragged, spec, dtype, params, quant, **over):
    return ragged.RaggedInferenceEngine(spec, ragged.RaggedConfig(**{**ENGINE, **over,
                                                                      "quant": quant}),
                                        dtype=dtype, params=params)


def quantized_calls(pa) -> int:
    return pa.quantized_decode_attention.calls + pa.quantized_prefill_attention.calls


def drift_probe(torch, ragged, spec, params, prompts, quant: str):
    """bench.py's drift probe: (tokens, spec accept rate)."""
    rcfg = ragged.RaggedConfig(max_tokens_per_step=ENGINE["max_tokens_per_step"], block_size=BS,
                               num_blocks=2 * MB + 1, max_blocks_per_seq=MB, quant=quant,
                               **DRIFT_PROBE)
    eng = ragged.RaggedInferenceEngine(spec, rcfg, dtype=torch.bfloat16, params=params)
    for i in range(DRIFT_PROMPTS):
        eng.put(i, prompts[i][:DRIFT_PROMPT_TOKENS], max_new_tokens=DRIFT_NEW)
    toks = eng.generate_all()
    torch.cuda.synchronize()
    acc = eng.spec_accepted / eng.spec_proposed if eng.spec_proposed else None
    return toks, acc


def warm_measured(torch, pa, eng, prompts, phase: str) -> dict:
    """A fused engine's warm run of the workload (capturing each program at
    its first dispatch), then its measured run: tokens/s, the schedule, the
    replays, paged launches and quantized-path calls of the measured run."""
    first_s = warm_run(torch, eng, prompts, phase)
    out, wall, launches, plain, d, power = measured_run(torch, pa, eng, prompts)
    gen = sum(len(v) for v in out.values())
    return dict(out=out, first_run_s_with_captures=first_s, wall_s=wall,
                generated_tokens_per_s=gen / wall,
                useful_tokens_per_s=(sum(len(p) for p in prompts) + gen) / wall,
                steps=d["steps"], forwards=d["forwards"],
                schedule=[d["steps"], d["scheduled_tokens"], d["padded_tokens"]],
                graph_replays=d["graph_replays"], eager_dispatches=d["eager_dispatches"],
                graph_captures=d["graph_captures"], kernel_launches=launches,
                plain_version_calls=plain, quantized_path_calls=quantized_calls(pa),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), **power)


def warm_gates(name: str, r: dict, eng, vocab: int, quantized: bool) -> list:
    """What a warm fused run of the workload must show: 32 streams of 48
    tokens in the vocabulary, the JAX schedule, every dispatch a replay and
    no capture, no leaked block; on a quantized pool 0 paged launches and
    quantized-path calls, else the paged kernels and no quantized call."""
    failed = []
    out = r["out"]
    if len(out) != N_REQ or any(len(v) != MAX_NEW or not all(0 <= t < vocab for t in v)
                                for v in out.values()):
        failed.append(f"{name}: a stream of the wrong length or vocabulary")
    if tuple(r["schedule"]) != FUSED_SCHEDULE or eng.allocator.free_blocks != \
            eng.cfg.num_blocks - 1:
        failed.append(f"{name}: schedule {r['schedule']} (want {FUSED_SCHEDULE}) or a leak")
    if r["graph_captures"] or r["eager_dispatches"] or r["graph_replays"] != r["steps"]:
        failed.append(f"{name}: after the warm run {r['graph_captures']} captures, "
                      f"{r['eager_dispatches']} eager, {r['graph_replays']} replays of "
                      f"{r['steps']} dispatches")
    launches, qcalls = r["kernel_launches"], r["quantized_path_calls"]
    if r["plain_version_calls"] or (
            (max(launches.values()) or qcalls <= 0) if quantized
            else (min(launches.values()) <= 0 or qcalls)):
        failed.append(f"{name}: paged launches {launches}, plain calls "
                      f"{r['plain_version_calls']}, quantized calls {qcalls}")
    return failed


def kv_quant_phase(torch, np, llama, ragged, pa, weights, params32, fused_run) -> dict:
    """Low-bit KV pools at Llama-3-8B (bf16 compute) on the reference bench's
    serving configuration: the codec on the card against the CPU bit for
    bit; ``quant="int8"`` and ``"fp8"`` on the 32-request workload, each
    measured after a warm run (0 captures, every dispatch a replay, 0 paged
    kernel launches, the quantized path counted, block bytes, one captured
    int8 decode step bit-identical to eager); the tier round trip of int8
    payloads after ``warmup()`` (demotions, spills, host promotions and
    prefetch hits, restore ms a block by tier, the tiers' bytes at the
    quantized block's), the handoff of int8 records (bytes, export /
    import ms) and bench.py's drift probe (the verdict printed, not gated:
    random weights leave close logits); in fp32 at 2 layers the device,
    fused, scheduler and speculation paths' int8 tokens equal the
    host-staged int8 engine's, and int8 payloads restored from the tiers or
    imported by handoff reproduce the cold int8 tokens. Returns the int8
    run's paged kernel launches (0) and quantized calls."""
    import shutil

    from deepspeed_tpu_torch.inference import kvquant

    failed = []
    x = torch.from_numpy(codec_rows(np))
    codec_bits = {}
    for name in kvquant.CODECS:
        c = kvquant.get_codec(name)
        qc, sc = kvquant.quantize_kv_rows(x.cuda(), c)
        qh, sh = kvquant.quantize_kv_rows(x, c)
        codec_bits[name] = same_bits(torch, qc, qh) and same_bits(torch, sc, sh)
    if not all(codec_bits.values()):
        failed.append(f"quantize_kv_rows on the card differs from the CPU: {codec_bits}")

    cfg = llama.LlamaConfig.llama3_8b()
    spec = llama.build(cfg)
    prompts = requests(np, cfg.vocab_size)
    # int8 and fp8 pools on the fused config, each measured warm
    runs, graph, launches, stats0 = {}, None, None, None
    for quant in ("int8", "fp8"):
        eng = quant_engine(ragged, spec, torch.bfloat16, weights, quant, **FUSED)
        stats = eng.kv_quant_stats()
        pool_bytes = sum(eng.cache[k].nbytes for k in ("k", "v"))
        r = warm_measured(torch, pa, eng, prompts, quant)
        failed += warm_gates(quant, r, eng, cfg.vocab_size, quantized=True)
        if (stats["block_bytes"], stats["fp16_block_bytes"]) != (KV_BLOCK_BYTES["quantized"],
                                                                KV_BLOCK_BYTES["fp16"]):
            failed.append(f"{quant}: block bytes {stats}, want {KV_BLOCK_BYTES}")
        if pool_bytes != ENGINE["num_blocks"] * KV_BLOCK_BYTES["quantized"]:
            failed.append(f"{quant}: pool bytes {pool_bytes}")
        out = r.pop("out")
        runs[quant] = dict(r, pool_bytes=pool_bytes, kv_quant_stats=eng.kv_quant_stats(),
                           bf16_streams_differing_from_engine_fused=sum(
                               out[i] != fused_run["tokens"][i] for i in out))
        if quant == "int8":
            stats0, launches = stats, r["kernel_launches"]
            graph = graph_vs_eager(torch, np, llama, eng)
            if not graph["bit_identical"]:
                failed.append(f"int8: a replayed decode step differs from eager: {graph}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # the tier round trip of int8 payloads, at 8B in bf16 and in fp32 at 2
    # layers (there: every pair identical)
    cfg2, p32 = params32
    spec2 = llama.build(cfg2)
    treqs = kv_tier_workload(np, cfg.vocab_size, KVQ_TIER_REQ)
    root = os.path.join("runs", f"kvquant-chip-smoke-{os.getpid()}")
    try:
        tier = kv_tier_run(torch, ragged, pa, spec, torch.bfloat16, weights, treqs,
                           os.path.join(root, "bf16"), quant="int8")
        tier32 = kv_tier_run(torch, ragged, pa, spec2, torch.float32, p32, treqs,
                             os.path.join(root, "fp32_2_layers"), quant="int8")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    st = tier["tier_stats"]
    for key in ("demotions", "spills", "promotions_host", "prefetch_hits"):
        if st[key] <= 0:
            failed.append(f"int8 tiers: {key} = {st[key]}")
    if tier["block_bytes"] != KV_BLOCK_BYTES["quantized"] or \
            st["host_bytes"] != st["host_blocks"] * KV_BLOCK_BYTES["quantized"]:
        failed.append(f"int8 tiers: block bytes {tier['block_bytes']}, host bytes "
                      f"{st['host_bytes']} of {st['host_blocks']} blocks")
    if tier32["pairs_identical"] != tier32["pairs"] or tier32["tier_stats"]["promotions"] <= 0:
        failed.append(f"fp32 int8 tiers: {tier32['pairs_identical']} of {tier32['pairs']} "
                      f"pairs identical, {tier32['tier_stats']['promotions']} promotions")
    for name, r in (("int8 tiers", tier), ("fp32 int8 tiers", tier32)):
        if r["tier_stats"]["codec"] != "int8" or r["tier_stats"]["sweep_removed"] or \
                not r["pool_clean"] or max(r["kernel_launches"].values()) or \
                r["plain_version_calls"] or r["quantized_path_calls"] <= 0:
            failed.append(f"{name}: {r}")

    # the handoff of int8 records at 8B: bytes and ms (streams against the
    # bf16 engine_fused's counted)
    hprompts = prompts[:KVQ_HANDOFF_REQ]
    hout, hstats, hlaunch, hplain = handoff_split(torch, ragged, pa, spec, torch.bfloat16,
                                                  weights, hprompts, quant="int8")
    if max(hlaunch.values()) or hplain or hstats["kv_blocks_exported"] != \
            hstats["kv_blocks_imported"] or not hstats["pools_clean"]:
        failed.append(f"handoff int8: {hstats}, launches {hlaunch}, plain {hplain}")

    # bench.py's drift probe, off against int8
    base, base_acc = drift_probe(torch, ragged, spec, weights, prompts, "off")
    qtok, q_acc = drift_probe(torch, ragged, spec, weights, prompts, "int8")
    verdict = kvquant.drift_verdict(
        kvquant.token_match_rate(base, qtok),
        abs(q_acc - base_acc) if base_acc is not None and q_acc is not None else None)
    torch.cuda.empty_cache()

    # fp32 at 2 layers: every path against the host-staged int8 engine, and
    # the handoff against cold int8 tokens
    rng = np.random.default_rng(2)
    pprompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
                for n in (40, 64, 100, 33, 150, 7, 80, 129)]
    host = quant_engine(ragged, spec2, torch.float32, p32, "int8", device_state=False)
    want32 = run(host, pprompts, MAX_NEW)
    del host
    parity = {}
    for name, over in KVQ_PARITY.items():
        e = quant_engine(ragged, spec2, torch.float32, p32, "int8", **over)
        runs32 = [run(e, pprompts, MAX_NEW) for _ in range(2)]  # the second replays
        parity[name] = dict(tokens_identical=all(r == want32 for r in runs32),
                            graph_replays=e.programs.replays)
        del e
    if not all(v["tokens_identical"] and v["graph_replays"] > 0 for v in parity.values()):
        failed.append(f"fp32 int8 paths against the host-staged engine: {parity}")
    single = quant_engine(ragged, spec2, torch.float32, p32, "int8", **FUSED)
    hwant = run(single, hprompts, MAX_NEW)
    del single
    hout32, hstats32, _, _ = handoff_split(torch, ragged, pa, spec2, torch.float32, p32,
                                           hprompts, quant="int8")
    hsame = sum(hout32[i] == hwant[i] for i in hwant)
    if hsame != len(hprompts):
        failed.append(f"fp32 int8 handoff: {hsame} of {len(hprompts)} streams equal")
    torch.cuda.empty_cache()

    emit("kv_quant", model="llama3_8b", dtype="bfloat16", source="bench.py:1180-1249,1381-1414",
         ragged_config=dict(ENGINE, **FUSED), requests=N_REQ, new_tokens_each=MAX_NEW,
         codec_bits_equal_cpu=codec_bits, kv_block_bytes=KV_BLOCK_BYTES,
         resident_multiplier_vs_fp16=stats0["resident_multiplier_vs_fp16"],
         runs=runs, int8_graph_vs_eager_bf16=graph,
         engine_fused_generated_tokens_per_s=fused_run["generated_tokens_per_s"],
         tiers_int8=dict(tier, ragged_config=dict(ENGINE, **FUSED, **KV_TIER),
                         prefix_groups=KV_TIER_GROUPS, prefix_tokens=KV_TIER_PREFIX,
                         prompt_tokens=max(PROMPT_LENS),
                         arrival_every_steps=KV_TIER_ARRIVAL_STEPS),
         handoff_int8=dict(requests=len(hprompts), **hstats,
                           bf16_streams_differing_from_engine_fused=sum(
                               hout[i] != fused_run["tokens"][i] for i in hout)),
         drift_probe=dict(DRIFT_PROBE, prompts=DRIFT_PROMPTS, prompt_tokens=DRIFT_PROMPT_TOKENS,
                          new_tokens=DRIFT_NEW, spec_accept_rate_off=base_acc,
                          spec_accept_rate_int8=q_acc, verdict=verdict),
         fp32_2_layers=dict(reduced="depth 32 -> 2 layers", paths_vs_host_staged=parity,
                            tiers=tier32, handoff_streams_equal_to_single_engine=hsame,
                            handoff=hstats32),
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if failed:
        raise AssertionError(f"kv_quant: {failed}")
    return launches, runs["int8"]["quantized_path_calls"]


def woq_phase(torch, np, llama, ragged, dense_mod, pa, weights, fused_run) -> dict:
    """Weight-only quantization at Llama-3-8B: ``quantize_params`` on the
    card against the CPU bit for bit (a slice of the weights with a zero
    and a tiny block), ``woq8`` and ``woq4`` on the bench's fused config
    over the 32-request workload, each measured after a warm run (tokens/s
    beside engine_fused's, the paged kernels launched as in bf16, the
    weights' bytes), and the dense engine through
    ``init_inference(dtype="int8")``. Returns the woq runs' launches."""
    from deepspeed_tpu_torch.ops import quantizer

    failed = []
    sub = {"layers": {"wq": weights["layers"]["wq"][:1].clone(),
                      "w_down": weights["layers"]["w_down"][:1].clone(),
                      "attn_norm": weights["layers"]["attn_norm"][:1].clone()},
           "lm_head": weights["lm_head"][:, :8192].contiguous(),
           "embed": weights["embed"][:16].clone()}
    sub["layers"]["wq"][0, 0, :256] = 0.0
    sub["layers"]["wq"][0, 1, :256] = 1e-30
    host = {k: (v.cpu() if not isinstance(v, dict) else {n: w.cpu() for n, w in v.items()})
            for k, v in sub.items()}
    params_bits = {}
    for bits in (8, 4):
        got = dict(named_leaves(quantizer.quantize_params(sub, bits)))
        want = dict(named_leaves(quantizer.quantize_params(host, bits)))
        params_bits[bits] = set(got) == set(want) and all(
            (same_bits(torch, got[k].values, want[k].values)
             and same_bits(torch, got[k].scales, want[k].scales))
            if isinstance(want[k], quantizer.QuantizedWeight) else same_bits(torch, got[k], want[k])
            for k in want)
    if not all(params_bits.values()):
        failed.append(f"quantize_params on the card differs from the CPU: {params_bits}")
    del sub, host

    cfg = llama.LlamaConfig.llama3_8b()
    spec = llama.build(cfg)
    prompts = requests(np, cfg.vocab_size)
    runs, total = {}, {}
    for quant in ("woq8", "woq4"):
        t0 = time.perf_counter()
        eng = quant_engine(ragged, spec, torch.bfloat16, weights, quant, **FUSED)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        nbytes = quantizer.params_nbytes(eng.params)
        r = warm_measured(torch, pa, eng, prompts, quant)
        failed += warm_gates(quant, r, eng, cfg.vocab_size, quantized=False)
        if nbytes != WEIGHT_BYTES[quant]:
            failed.append(f"{quant}: weights {nbytes} B, want {WEIGHT_BYTES[quant]}")
        out = r.pop("out")
        runs[quant] = dict(r, weight_bytes=nbytes, quantize_s=quantize_s,
                           bf16_streams_differing_from_engine_fused=sum(
                               out[i] != fused_run["tokens"][i] for i in out))
        add_counts(total, r["kernel_launches"])
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # the dense engine through init_inference(dtype="int8"): woq8, bf16
    # compute; padded batches of 8 prompts of 128 tokens, 16 new
    t0 = time.perf_counter()
    dense = dense_mod.init_inference(spec, {"dtype": "int8", "params": weights})
    torch.cuda.synchronize()
    dquant_s = time.perf_counter() - t0
    batch = np.stack([p[:128] for p in prompts if len(p) >= 128][:8])
    first = dense.generate(batch, max_new_tokens=16)
    torch.cuda.synchronize()
    captures = dense.programs.captures
    t0 = time.perf_counter()
    again = dense.generate(batch, max_new_tokens=16)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    dres = dict(quantize_bits=dense.quantize_bits, weight_bytes=quantizer.params_nbytes(
        dense.params), quantize_s=dquant_s, batch=list(batch.shape), new_tokens_each=16,
        repeat_wall_s=dwall, generated_tokens_per_s=batch.shape[0] * 16 / dwall,
        repeat_captures=dense.programs.captures - captures,
        repeat_identical=bool(np.array_equal(first, again)))
    if dres["weight_bytes"] != WEIGHT_BYTES["woq8"] or dres["repeat_captures"] or \
            not dres["repeat_identical"] or not (0 <= again[:, 128:]).all() or \
            not (again[:, 128:] < cfg.vocab_size).all():
        failed.append(f"dense woq8: {dres}")
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    emit("woq", model="llama3_8b", dtype="bfloat16", ragged_config=dict(ENGINE, **FUSED),
         requests=N_REQ, new_tokens_each=MAX_NEW, params_bits_equal_cpu=params_bits,
         weight_bytes_bf16=WEIGHT_BYTES["bf16"], runs=runs, dense_init_inference_int8=dres,
         engine_fused_generated_tokens_per_s=fused_run["generated_tokens_per_s"],
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if failed:
        raise AssertionError(f"woq: {failed}")
    return total


# ------------------------------------------------------------------- train
def train_cfg(llama, layers: int):
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=layers)


def flash_counts(fa) -> dict:
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_dkdv": fa.flash_attention_dkdv.launches,
            "flash_dq": fa.flash_attention_dq.launches}


def train_phase(torch, np, llama, engine_mod, fa):
    """The training main path: bench.py:trial_main's config on Llama-3-8B
    widths at 4 layers; per-step loss, grad norm, ms and flash launches."""
    cfg = train_cfg(llama, TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg),
                                         config=dict(TRAIN_CONFIG), seed=0)
    torch.cuda.synchronize()
    emit("train_init", model="llama3_8b widths", layers=cfg.num_layers,
         reduced="depth 32 -> 4 layers (fp32 masters + Adam state of 32 layers need "
                 "128.5 GB; one card has 80)", num_params=llama.num_params(cfg),
         memory_allocated_bytes=torch.cuda.memory_allocated(), config=TRAIN_CONFIG,
         init_s=time.perf_counter() - t0)
    rng = np.random.default_rng(0)

    def make_batch():
        return {"input_ids": rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                          dtype=np.int32)}

    for _ in range(WARMUP_STEPS):
        float(eng.train_batch(make_batch()))
    batches = [make_batch() for _ in range(TIMED_STEPS)]
    fa.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sampler = PowerSampler()
    steps = []
    try:
        for b in batches:
            before = flash_counts(fa)
            loss = float(eng.train_batch(b))
            after = flash_counts(fa)
            steps.append(dict(loss=loss, grad_norm=eng.get_global_grad_norm(),
                              ms=eng.tput_timer.last_duration * 1e3,
                              launches={k: after[k] - before[k] for k in after}))
            emit("train_step", step=eng.global_steps, **steps[-1])
    finally:
        power = sampler.stop()
    launches = flash_counts(fa)
    plain_calls = fa.flash_attention_fwd_ref.calls + fa.flash_attention_bwd_ref.calls
    total_s = sum(s["ms"] for s in steps) / 1e3
    tokens_per_s = TIMED_STEPS * TRAIN_BATCH * TRAIN_SEQ / total_s
    mfu = tokens_per_s * llama.flops_per_token(cfg, TRAIN_SEQ) / BF16_FLOPS_PER_S
    per_step = {k: v // TIMED_STEPS for k, v in launches.items()}
    emit("train_run", steps=TIMED_STEPS, time_per_step=total_s / TIMED_STEPS,
         tokens_per_s=tokens_per_s, mfu=mfu,
         flops_per_token=llama.flops_per_token(cfg, TRAIN_SEQ),
         peak_flops=BF16_FLOPS_PER_S, kernel_launches_per_step=per_step,
         plain_version_calls=plain_calls, skipped_steps=eng.skipped_steps,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         nvidia_smi=nvidia_smi("name", "power.limit"), **power)
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError("a non-finite loss or grad norm in the timed steps")
    # each layer: a forward, its recompute in the backward (remat), a backward
    expected = {"flash_fwd": 2 * TRAIN_LAYERS, "flash_dkdv": TRAIN_LAYERS,
                "flash_dq": TRAIN_LAYERS}
    if launches != {k: TIMED_STEPS * n for k, n in expected.items()}:  # so per_step is exact
        raise AssertionError(f"flash launches over {TIMED_STEPS} steps: {launches}, "
                             f"want {expected} a step")
    if plain_calls:
        raise AssertionError(f"plain attention ran {plain_calls} times on the main path")

    profile_phase(torch, lambda: eng.train_batch(make_batch()), phase="train_profile")

    # memorisation: 8 steps on one repeated batch
    batch = make_batch()
    losses = [float(eng.train_batch(batch)) for _ in range(8)]
    emit("train_repeated_batch", losses=losses, falls=losses[-1] < losses[0])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {losses}")
    del eng
    torch.cuda.empty_cache()
    return per_step


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def grads_of(loss_fn, masters: dict, batch: dict, dtype):
    """Loss and fp32 gradients of ``loss_fn`` at the compute-dtype cast of
    ``masters``, as the engine computes them."""
    from deepspeed_tpu_torch.runtime import precision

    loss = loss_fn(precision.cast_to_compute(masters, dtype), batch)
    loss.backward()
    grads = {}
    for name, x in named_leaves(masters):
        grads[name], x.grad = x.grad, None
    return loss.detach(), grads


def compare_grads(got: dict, want: dict) -> dict:
    rel = {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want}
    err = {k: (got[k] - want[k]).abs().max().item() for k in want}
    return {"max_abs_err": max(err.values()), "max_rel_frobenius_err": max(rel.values()),
            "rel_frobenius_err_by_leaf": rel}


def train_parity(torch, np, llama, engine_mod) -> dict:
    """The same loss through the kernels and through the plain attention
    path (``impl="plain"``, swapped into the spec locally): fp32 at 2 layers
    (loss, every gradient, a 4-step trajectory) and bf16 at 4 layers
    (gradients)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    out = {}
    for name, layers, b, s, dtype, steps in (("fp32", 2, 1, 2048, torch.float32, 4),
                                            ("bf16", TRAIN_LAYERS, 1, TRAIN_SEQ,
                                             torch.bfloat16, 0)):
        cfg = train_cfg(llama, layers)
        policy = engine_mod.resolve_remat_policy("dots_saveable")
        spec = llama.build(cfg, remat=True, remat_policy=policy)
        plain = dataclasses.replace(spec, loss_fn=partial(
            llama.loss_fn, cfg, attn_impl="plain", remat=True, remat_policy=policy))
        rng = np.random.default_rng(3)
        batch = {"input_ids": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)).to("cuda")}
        gen = torch.Generator(device="cuda").manual_seed(7)
        masters = llama.init_params(cfg, gen, torch.float32, "cuda")
        for _, x in named_leaves(masters):
            x.requires_grad_(True)
        fa.reset_counts()
        loss_k, g_k = grads_of(spec.loss_fn, masters, batch, dtype)
        launches = flash_counts(fa)
        loss_p, g_p = grads_of(plain.loss_fn, masters, batch, dtype)
        res = dict(loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
                   loss_abs_err=abs(loss_k.item() - loss_p.item()),
                   kernel_launches=launches, **compare_grads(g_k, g_p))
        del g_k, g_p, masters
        torch.cuda.empty_cache()
        if steps:
            traj = {}
            for label, model in (("kernels", spec), ("plain", plain)):
                config = dict(TRAIN_CONFIG, train_micro_batch_size_per_device=b,
                              sequence_length=s, bf16={"enabled": False})
                eng, _, _, _ = engine_mod.initialize(model=model, config=config, seed=7)
                traj[label] = [float(eng.train_batch({"input_ids": batch["input_ids"].cpu()
                                                      .numpy()})) for _ in range(steps)]
                del eng
                torch.cuda.empty_cache()
            res["trajectory"] = traj
            res["trajectory_max_abs_err"] = max(abs(a - c) for a, c in
                                                zip(traj["kernels"], traj["plain"]))
        out[name] = dict(model="llama3_8b widths", layers=layers, batch=b, seq=s, **res)
    return out


# (run, reading, limit): fp32 separates summation order from a wrong
# kernel; bf16 rounds activations and gradients at different places
TRAIN_PARITY_LIMITS = [("fp32", "loss_abs_err", 1e-3), ("fp32", "trajectory_max_abs_err", 1e-3),
                       ("fp32", "max_rel_frobenius_err", 1e-3),
                       ("bf16", "max_rel_frobenius_err", 5e-2)]


def train_parity_phase(torch, np, llama, engine_mod):
    out = train_parity(torch, np, llama, engine_mod)
    for name, res in out.items():
        emit(f"train_parity_{name}", **res)
    emit("train_parity_limits", **{f"{run}_{key}": lim for run, key, lim in TRAIN_PARITY_LIMITS})
    for run, key, limit in TRAIN_PARITY_LIMITS:
        if not out[run][key] <= limit:  # a NaN reading fails too
            raise AssertionError(f"train parity {run} {key}: {out[run][key]} > {limit}")


# ------------------------------------- ZeRO stages and checkpoints (item 10)
ZERO_STEPS = 4
ZERO_REL_LIMIT = 1e-6          # stages 1-3 against stage 0 where not bitwise
CKPT_LAYERS = 1                # checkpoint cell: full width, depth cut to 1 layer
CKPT_STATE_BYTES_PER_PARAM = 12  # fp32 master + Adam mu + nu


def nccl_group(torch):
    """Environment for a one-rank NCCL group on cuda:0 (the engine's
    ``init_distributed`` starts it): NCCL refuses two ranks on one device."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")


def end_nccl_group():
    from deepspeed_tpu_torch.comm import comm

    comm.destroy_distributed()
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(k, None)


def zero_config(stage: int, **extra) -> dict:
    return dict(TRAIN_CONFIG, zero_optimization={"stage": stage},
                comms_logger={"enabled": True}, **extra)


def zero_batches(np, vocab: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)}
            for _ in range(n)]


def train_zero_phase(torch, np, llama, engine_mod, fa) -> dict:
    """bench.py's mfu_zero3 on one card (``bench.py:173-176``): the training
    cell at ZeRO stages 0-3 under a one-rank NCCL group, the same 4 batches
    each; stages 1-3 held to stage 0's losses and grad norms."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.utils.comms_logging import COMMS_LOGGER

    cfg = train_cfg(llama, TRAIN_LAYERS)
    batches = zero_batches(np, cfg.vocab_size, ZERO_STEPS, seed=5)
    runs, per_step = {}, {}
    nccl_group(torch)
    try:
        for stage in (0, 1, 2, 3):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg),
                                                 config=zero_config(stage), seed=0)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            COMMS_LOGGER.reset()
            fa.reset_counts()
            losses, norms, ms, launches = [], [], [], []
            for b in batches:
                before = flash_counts(fa)
                losses.append(float(eng.train_batch(b)))
                after = flash_counts(fa)
                norms.append(eng.get_global_grad_norm())
                ms.append(eng.tput_timer.last_duration * 1e3)
                launches.append({k: after[k] - before[k] for k in after})
            plain = fa.flash_attention_fwd_ref.calls + fa.flash_attention_bwd_ref.calls
            timed = ms[1:]   # the first step also starts NCCL's and cuBLAS's work
            step_ms = sum(timed) / len(timed)
            runs[stage] = dict(losses=losses, grad_norms=norms, step_ms=ms,
                               time_per_step=step_ms / 1e3,
                               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
                               kernel_launches_per_step=launches[-1],
                               plain_version_calls=plain, init_s=init_s,
                               sharded_leaves=sum(lp.state_sharded for lp in eng.plan),
                               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                               comms=COMMS_LOGGER.rows())
            if stage == 3:
                comms_text = comm.log_summary()
            per_step[stage] = launches[-1]
            expected = {"flash_fwd": 2 * TRAIN_LAYERS, "flash_dkdv": TRAIN_LAYERS,
                        "flash_dq": TRAIN_LAYERS}
            if any(n != expected for n in launches):
                raise AssertionError(f"train_zero stage {stage}: flash launches {launches}, "
                                     f"want {expected} a step")
            if plain:
                raise AssertionError(f"train_zero stage {stage}: plain attention ran {plain} "
                                     "times")
            if not all(np.isfinite(x) for x in losses + norms):
                raise AssertionError(f"train_zero stage {stage}: a non-finite loss or norm")
            eng.destroy()
            del eng
    finally:
        end_nccl_group()
    base = runs[0]
    out = {}
    for stage in (1, 2, 3):
        r = runs[stage]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"] + r["grad_norms"],
                                                       base["losses"] + base["grad_norms"]))
        bitwise = r["losses"] == base["losses"] and r["grad_norms"] == base["grad_norms"]
        out[stage] = dict(bitwise=bitwise, max_rel_diff=rel)
    emit("train_zero", model="llama3_8b widths", layers=TRAIN_LAYERS,
         group="nccl, world 1 on cuda:0", steps=ZERO_STEPS, source="bench.py:173-176",
         reduced="depth 32 -> 4 layers; world 1 (one card: NCCL refuses two ranks on one "
                 "device), so every leaf is one shard and each collective runs on one rank",
         stages={s: {k: v for k, v in r.items() if k != "comms"} for s, r in runs.items()},
         against_stage0=out, limit_rel=ZERO_REL_LIMIT,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    emit("train_zero_comms", stages={s: r["comms"] for s, r in runs.items()},
         summary_stage3=comms_text)
    for stage, res in out.items():
        if not (res["bitwise"] or res["max_rel_diff"] <= ZERO_REL_LIMIT):
            raise AssertionError(f"train_zero stage {stage} against stage 0: {res}")
    return per_step


def ckpt_batch(np, vocab: int, i: int) -> dict:
    """Batch ``i`` of the checkpoint cell's deterministic stream."""
    rng = np.random.default_rng(6000 + i)
    return {"input_ids": rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)}


def ckpt_loader(np, vocab: int):
    """The stream as a ``CheckpointableLoader``: its position rides the
    manifest, and the sentinel's quarantine skips its batches."""
    from deepspeed_tpu_torch.runtime.dataloader import CheckpointableLoader

    def factory(skip):
        def gen():
            i = skip
            while True:
                yield ckpt_batch(np, vocab, i)
                i += 1
        return gen()

    return CheckpointableLoader(factory)


def checkpoint_phase(torch, np, llama, engine_mod, fa):
    """Save at stage 3 under a one-rank NCCL group, load into a fresh stage-0
    engine through the fallback ladder past a corrupt newer tag, and resume:
    the resumed losses equal the continuous run's bitwise. The batches come
    from ``ckpt_loader``, whose position the tags carry. Returns the
    launches, the save dir and the verified older tag, which the sentinel
    and serve-from-checkpoint phases read (the corrupt tag is removed and
    ``latest`` names the older one); the caller removes the dir."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.checkpoint import engine as ckpt

    cfg = train_cfg(llama, CKPT_LAYERS)
    nparams = llama.num_params(cfg)
    root = tempfile.gettempdir()
    need = 2 * CKPT_STATE_BYTES_PER_PARAM * nparams  # two tags on disk at once
    free = shutil.disk_usage(root).free
    if free < 1.1 * need:
        raise AssertionError(f"checkpoint: {free} bytes free under {root}, the phase "
                             f"writes {need}")
    save_dir = tempfile.mkdtemp(prefix="dstpu-ckpt-chip-smoke-", dir=root)
    launches = {k: 0 for k in flash_counts(fa)}
    ok = False
    nccl_group(torch)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        fa.reset_counts()
        eng, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg),
                                             config=zero_config(3), seed=0,
                                             training_data=ckpt_loader(np, cfg.vocab_size))
        first = [float(eng.train_batch()) for _ in range(2)]
        t0 = time.perf_counter()
        older = eng.save_checkpoint(save_dir)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(older, f)) for f in os.listdir(older))
        continuous = [float(eng.train_batch()) for _ in range(2)]
        newer = eng.save_checkpoint(save_dir)
        eng.destroy()
        del eng
        launches = flash_counts(fa)
        gc.collect()
        torch.cuda.empty_cache()
        # corrupt one fragment of the newer tag: cut its model shard short
        victim = os.path.join(newer, "model_shard_p0.npz")
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(size - min(1 << 20, size // 2))
        fresh, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg),
                                               config=zero_config(0), seed=1,
                                               training_data=ckpt_loader(np, cfg.vocab_size))
        telemetry.TELEMETRY.reset()
        telemetry.configure(enabled=True)
        try:
            t0 = time.perf_counter()
            loaded, _ = fresh.load_checkpoint(save_dir)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            reg = telemetry.TELEMETRY.registry
            verify = reg.histogram("checkpoint_verify_seconds")
            ladder = dict(
                verify_s=verify.sum(), verifications=verify.count(),
                fallbacks=reg.counter("checkpoint_fallback_total").value(),
                corrupt_size_mismatch=reg.counter("checkpoint_corrupt_total").value(
                    stage="size-mismatch"))
        finally:
            telemetry.TELEMETRY.reset()
        before_resume = flash_counts(fa)
        resumed = [float(fresh.train_batch()) for _ in range(2)]
        after_resume = flash_counts(fa)
        launches = {k: launches[k] + after_resume[k] - before_resume[k] for k in launches}
        steps = fresh.global_steps
        fresh.destroy()
        del fresh
        # what the later phases read: the verified older tag, named by latest
        shutil.rmtree(newer)
        ckpt.write_latest(save_dir, os.path.basename(older))
        ok = True
    finally:
        end_nccl_group()
        if not ok:
            shutil.rmtree(save_dir, ignore_errors=True)
    emit("checkpoint", model="llama3_8b widths", layers=CKPT_LAYERS, num_params=nparams,
         reduced="depth 32 -> 1 layer (fp32 masters + Adam mu + nu at 12 bytes a "
                 "parameter, two tags on disk at once)",
         saved_stage=3, loaded_stage=0, group="nccl, world 1 on cuda:0",
         bytes_written=written, save_s=save_s, load_s=load_s, **ladder,
         tags=[os.path.basename(older), os.path.basename(newer)],
         corrupted=os.path.relpath(victim, save_dir), loaded=os.path.basename(loaded),
         losses_before_save=first, continuous=continuous, resumed=resumed,
         resumed_equal_bitwise=resumed == continuous, global_steps_after=steps,
         kernel_launches=launches, disk_free_bytes=free,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if os.path.basename(loaded) != os.path.basename(older):
        raise AssertionError(f"checkpoint: the ladder loaded {loaded}, want {older}")
    if not (ladder["fallbacks"] >= 1 and ladder["corrupt_size_mismatch"] >= 1):
        raise AssertionError(f"checkpoint: the corrupt tag was not walked past: {ladder}")
    if resumed != continuous:
        raise AssertionError(f"checkpoint: resumed {resumed} != continuous {continuous}")
    if not written >= CKPT_STATE_BYTES_PER_PARAM * nparams:
        raise AssertionError(f"checkpoint: {written} bytes written for {nparams} parameters")
    return launches, save_dir, older


# ------------------------- item 10, second part (a): the single-card rest
class HostReads:
    """Counts reads of CUDA tensors on the host (``item``, ``tolist``,
    ``bool``, ``float``, ``int``: each waits for the device) while installed."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __init__(self, torch):
        self.torch, self.reads = torch, 0
        self._orig = {n: getattr(torch.Tensor, n) for n in self.NAMES}

    def __enter__(self):
        counter = self

        def wrap(fn):
            def read(t, *a, **k):
                if t.is_cuda:
                    counter.reads += 1
                return fn(t, *a, **k)
            return read

        for n, fn in self._orig.items():
            setattr(self.torch.Tensor, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.torch.Tensor, n, fn)


class DeviceSyncs:
    """Counts the waits for the card that ``torch.cuda.set_sync_debug_mode``
    reports (its warning "called a synchronizing CUDA operation", one a
    wait: a read back, a copy from pageable host memory, a stream
    synchronize) while installed, by the Python line that waited
    (``sites``). Its other warnings are not waits: the mode's first use
    warns once that it is a prototype. It sees waits in PyTorch's own code,
    which ``HostReads`` does not."""

    def __init__(self, torch):
        self.torch, self.syncs, self.sites = torch, 0, {}

    def __enter__(self):
        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" not in str(message):
                return
            self.syncs += 1
            site = f"{os.path.basename(filename)}:{lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = show
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)


def sync_controls(torch) -> dict:
    """``DeviceSyncs``' readings of known waits: a read back (``item``) and
    a constant made on the host (``torch.tensor(x, device="cuda")``)."""
    out = {}
    for name, fn in (("item", lambda: torch.ones(1, device="cuda").item()),
                     ("host_constant", lambda: torch.tensor(0.5, device="cuda"))):
        with DeviceSyncs(torch) as ds:
            fn()
        out[name] = ds.syncs
    return out


def timed_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


FBS_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_device=1,
                  gradient_accumulation_steps=2)
FBS_STEPS = 2


def train_fbs_phase(torch, np, llama, engine_mod, fa) -> dict:
    """The 4-layer training cell at GAS 2 (two micro-batches of 1 x 4096):
    two steps through ``backward`` x 2 + ``step`` and two through
    ``train_batch`` from the same init. Gates: losses and every master equal
    bit for bit; the flash kernels launch, the plain attention never runs."""
    cfg = train_cfg(llama, TRAIN_LAYERS)
    rng = np.random.default_rng(11)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (2, TRAIN_SEQ), dtype=np.int32)}
               for _ in range(FBS_STEPS)]
    unseen = rng.integers(0, cfg.vocab_size, (1, TRAIN_SEQ), dtype=np.int32)  # eval's row
    runs = {}
    for way in ("backward_step", "train_batch"):
        gc.collect()
        torch.cuda.empty_cache()
        eng, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg),
                                             config=dict(FBS_CONFIG), seed=0)
        fa.reset_counts()
        losses, ms = [], []
        for b in batches:
            if way == "train_batch":
                loss, t = timed_ms(torch, lambda: eng.train_batch(b))
            else:
                def fbs():
                    ls = [eng.backward({"input_ids": b["input_ids"][g:g + 1]}) for g in (0, 1)]
                    if not eng.is_gradient_accumulation_boundary():
                        raise AssertionError("train_fbs: no boundary after 2 micro-batches")
                    eng.step()
                    return torch.stack(ls).mean()
                loss, t = timed_ms(torch, fbs)
            losses.append(loss)
            ms.append(t)
        launches = flash_counts(fa)
        plain = fa.flash_attention_fwd_ref.calls + fa.flash_attention_bwd_ref.calls
        eval_loss = float(eng.forward({"input_ids": unseen}))
        masters = {k: p.detach().clone() for k, p in named_leaves(eng.params)}  # 7.7 GB
        runs[way] = dict(losses=[float(x) for x in losses], loss_bits=[
            int(np.float32(float(x)).view(np.uint32)) for x in losses], step_ms=ms,
            kernel_launches=launches, plain_version_calls=plain, eval_loss=eval_loss,
            masters=masters, steps=eng.global_steps)
        eng.destroy()
        del eng
    a, b = runs["backward_step"], runs["train_batch"]
    differing = [k for k in a["masters"] if not torch.equal(a["masters"][k], b["masters"][k])]
    for r in runs.values():
        r.pop("masters")
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_fbs", model="llama3_8b widths", layers=TRAIN_LAYERS, config=FBS_CONFIG,
         source="deepspeed_tpu/runtime/engine.py:2355-2460", runs=runs,
         losses_bitwise=a["loss_bits"] == b["loss_bits"], masters_differing=differing,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if a["loss_bits"] != b["loss_bits"] or differing:
        raise AssertionError(f"train_fbs: backward/step differs from train_batch: losses "
                             f"{a['losses']} vs {b['losses']}, masters {differing}")
    expected = {"flash_fwd": 4 * TRAIN_LAYERS * FBS_STEPS,
                "flash_dkdv": 2 * TRAIN_LAYERS * FBS_STEPS,
                "flash_dq": 2 * TRAIN_LAYERS * FBS_STEPS}
    for way, r in runs.items():
        if r["kernel_launches"] != expected or r["plain_version_calls"]:
            raise AssertionError(f"train_fbs {way}: launches {r['kernel_launches']} (want "
                                 f"{expected}), plain calls {r['plain_version_calls']}")
    return a["kernel_launches"]


# bench.py:learn_trial_main's accelerator config (:1041-1066)
LEARN_MODEL = dict(vocab_size=256, hidden_size=384, intermediate_size=1024, num_layers=6,
                   num_heads=6, num_kv_heads=6, max_seq_len=512)
LEARN_STEPS, LEARN_BATCH, LEARN_SEQ = 50, 32, 512
LEARN_CONFIG = {
    "train_micro_batch_size_per_device": LEARN_BATCH, "gradient_accumulation_steps": 1,
    "steps_per_print": 0, "gradient_clipping": 1.0, "sequence_length": LEARN_SEQ,
    "optimizer": {"type": "adamw", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 10}},
    "mesh": {"data": -1},
}


def learn_corpus(np):
    """``bench.py:1033-1040``: the bytes of ``deepspeed_tpu/**/*.py``, read
    as files (never imported), joined by newlines, in sorted walk order."""
    here = os.path.dirname(os.path.abspath(__file__))
    chunks = []
    for root, _, files in sorted(os.walk(os.path.join(here, "deepspeed_tpu"))):
        for f in sorted(files):
            if f.endswith(".py"):
                with open(os.path.join(root, f), "rb") as fh:
                    chunks.append(fh.read())
    return np.frombuffer(b"\n".join(chunks), np.uint8).astype(np.int32)


def learn_phase(torch, np, llama, engine_mod, fa) -> dict:
    """``bench.py:learn_trial_main`` on the card: a byte-level Llama learns
    the repository's own source, 50 steps, with the sentinel on, then the
    same run with it off. Gates: ``learn_pass`` (final < 0.7 x initial, the
    means of the first and last 3 losses), 0 anomalies, losses bitwise equal
    to the sentinel-off run, the same host reads a step and the same device
    syncs in all (``DeviceSyncs``) both ways."""
    corpus = learn_corpus(np)
    cfg = llama.LlamaConfig(**LEARN_MODEL)
    starts_rng = np.random.default_rng(1)
    starts = [starts_rng.integers(0, len(corpus) - LEARN_SEQ - 1, LEARN_BATCH)
              for _ in range(LEARN_STEPS)]
    batches = [{"input_ids": np.stack([corpus[s:s + LEARN_SEQ] for s in st])} for st in starts]
    runs, launches = {}, None
    for label, sentinel in (("sentinel_on", True), ("sentinel_off", False)):
        config = dict(LEARN_CONFIG, sentinel={"enabled": sentinel})
        eng, _, _, _ = engine_mod.initialize(model=partial(llama.build, cfg), config=config,
                                             seed=0)
        fa.reset_counts()
        losses, ms, reads, syncs, sites = [], [], [], [], {}
        for b in batches:
            with HostReads(torch) as hr, DeviceSyncs(torch) as ds:
                loss, t = timed_ms(torch, lambda: eng.train_batch(b))
            reads.append(hr.reads)
            syncs.append(ds.syncs)
            for k, n in ds.sites.items():
                sites[k] = sites.get(k, 0) + n
            ms.append(t)
            losses.append(float(loss))
        if sentinel:
            launches = flash_counts(fa)
            anomalies = eng._sentinel.anomalies
        plain = fa.flash_attention_fwd_ref.calls + fa.flash_attention_bwd_ref.calls
        initial, final = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        runs[label] = dict(losses=losses, step_ms=ms, median_step_ms=float(np.median(ms[1:])),
                           host_reads_per_step=sorted(set(reads)),
                           device_syncs_by_step=syncs, device_syncs=sum(syncs),
                           device_sync_sites=sites,
                           initial=initial,
                           final=final, learn_pass=bool(final < 0.7 * initial),
                           plain_version_calls=plain, compute_dtype=str(eng.config.compute_dtype))
        eng.destroy()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs["sentinel_on"], runs["sentinel_off"]
    bitwise = on["losses"] == off["losses"]
    controls = sync_controls(torch)
    emit("learn", model=LEARN_MODEL, steps=LEARN_STEPS, batch=LEARN_BATCH, seq=LEARN_SEQ,
         source="bench.py:1018-1086", corpus_bytes=int(len(corpus)), config=LEARN_CONFIG,
         head_dim=cfg.hd, runs=runs, learn_initial_loss=on["initial"],
         learn_final_loss=on["final"], learn_pass=on["learn_pass"], anomalies=anomalies,
         losses_bitwise_sentinel_on_off=bitwise, kernel_launches=launches,
         device_sync_controls=controls, nvidia_smi=nvidia_smi("name", "power.limit"))
    if not (on["learn_pass"] and anomalies == 0 and bitwise):
        raise AssertionError(f"learn: pass {on['learn_pass']}, anomalies {anomalies}, "
                             f"bitwise against sentinel off {bitwise}")
    if on["host_reads_per_step"] != off["host_reads_per_step"]:
        raise AssertionError(f"learn: host reads a step {on['host_reads_per_step']} with the "
                             f"sentinel, {off['host_reads_per_step']} without")
    # the sentinel adds no wait for the card; the counter sees a known one
    if on["device_syncs"] != off["device_syncs"] or controls["item"] < 1:
        raise AssertionError(f"learn: {on['device_syncs']} device syncs in {LEARN_STEPS} "
                             f"steps with the sentinel, {off['device_syncs']} without "
                             f"(controls {controls})")
    if min(launches.values()) <= 0 or on["plain_version_calls"]:
        raise AssertionError(f"learn: flash launches {launches}, plain calls "
                             f"{on['plain_version_calls']}")
    return launches


SENT_TOTAL = 8          # the sentinel cell's steps: from the tag's 2 to 8
SENT_NAN_AFTER = 3      # train.grads fires on its 4th call: step 5
SENT_POISON_BATCH = 7   # the stream's batch 7 (step 7) is poisoned


def sentinel_config(save_dir: str, state_dir: str) -> dict:
    """The checkpoint cell at stage 0 with the reference worker's sentinel
    settings (``bench.py:2412-2423``): the loss gate armed after 3 steps."""
    return dict(TRAIN_CONFIG, sentinel={
        "enabled": True, "warmup_steps": 3, "report_dir": os.path.join(state_dir, "reports"),
        "state_dir": state_dir, "checkpoint_dir": save_dir})


def sentinel_phase(torch, np, llama, engine_mod, fa, save_dir: str) -> dict:
    """Self-healing at Llama-3-8B widths, 1 layer, on the checkpoint cell's
    tag: a stage-0 engine with the sentinel loads it (no second hash pass:
    the checkpoint phase verified it), takes a nan-grads fault at
    ``train.grads`` (strike 1: quarantine, the tag pinned) and a poisoned
    batch at ``data.batch`` (strike 2: a verified full-width load, the
    replay skipping both batches). A clean sentinel run, its quarantine
    pre-seeded, loads the same tag. Gates: the stitched losses equal the
    clean run's bit for bit, one quarantine and one rollback, 0 anomalies
    in the clean run."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.runtime import sentinel as sentinel_mod
    from deepspeed_tpu_torch.serving import faults

    cfg = train_cfg(llama, CKPT_LAYERS)
    work = tempfile.mkdtemp(prefix="dstpu-sentinel-chip-smoke-")
    poison = sentinel_mod.batch_fingerprint(ckpt_batch(np, cfg.vocab_size, SENT_POISON_BATCH))
    inj = faults.get_fault_injector()
    runs = {}
    fa.reset_counts()
    try:
        for label in ("chaos", "clean"):
            state = os.path.join(work, label)
            if label == "clean":
                sentinel_mod.save_quarantine(state, runs["chaos"]["quarantine"])
            gc.collect()
            torch.cuda.empty_cache()
            eng, _, _, _ = engine_mod.initialize(
                model=partial(llama.build, cfg), config=sentinel_config(save_dir, state),
                seed=1, training_data=ckpt_loader(np, cfg.vocab_size))
            _, load_ms = timed_ms(torch, lambda: eng.load_checkpoint(save_dir, verify=False))
            if label == "chaos":
                inj.configure([{"point": "train.grads", "kind": "nan-grads",
                                "after": SENT_NAN_AFTER, "times": 1},
                               {"point": "data.batch", "kind": "poison-batch",
                                "request_id": poison, "times": 1}])
            traj, events, ms = {}, [], []
            try:
                while eng.global_steps < SENT_TOTAL:
                    step = eng.global_steps
                    loss, t = timed_ms(torch, lambda: eng.train_batch())
                    if eng.global_steps <= step:
                        events.append({"rollback_from": step, "to": eng.global_steps,
                                       "seconds": eng.last_rollback_s})
                        continue
                    traj[step] = float(loss)  # a replayed step overwrites its first run
                    ms.append(t)
            finally:
                inj.reset()
            runs[label] = dict(losses=[traj.get(s) for s in range(2, SENT_TOTAL)],
                               rollbacks=events, load_s_unverified=load_ms / 1e3,
                               step_ms=ms, anomalies=eng._sentinel.anomalies,
                               quarantine=list(eng._sentinel.quarantined),
                               skipped_by_loader=eng.training_dataloader.quarantined_skipped,
                               reports=sorted(os.listdir(os.path.join(state, "reports")))
                               if os.path.isdir(os.path.join(state, "reports")) else [])
            eng.destroy()
            del eng
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = flash_counts(fa)
    chaos, clean = runs["chaos"], runs["clean"]
    bitwise = chaos["losses"] == clean["losses"] and None not in chaos["losses"]
    emit("sentinel", model="llama3_8b widths", layers=CKPT_LAYERS, zero_stage=0,
         source="bench.py:2347-2423,2733-2800", steps=f"2..{SENT_TOTAL - 1} from the tag",
         faults={"train.grads": f"nan-grads after {SENT_NAN_AFTER}",
                 "data.batch": f"poison-batch on batch {SENT_POISON_BATCH}"},
         runs=runs, stitched_bitwise=bitwise,
         rollback_s=[e["seconds"] for e in chaos["rollbacks"]], kernel_launches=launches,
         full_width_loads=3, nvidia_smi=nvidia_smi("name", "power.limit"))
    if not (bitwise and len(chaos["rollbacks"]) == 1 and len(chaos["quarantine"]) == 2
            and clean["anomalies"] == 0 and chaos["anomalies"] == 2
            and any(n.startswith("sentinel_rollback") for n in chaos["reports"])):
        raise AssertionError(f"sentinel: stitched {chaos['losses']} vs clean "
                             f"{clean['losses']}, rollbacks {chaos['rollbacks']}, quarantine "
                             f"{chaos['quarantine']}, anomalies {chaos['anomalies']} / "
                             f"{clean['anomalies']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"sentinel: flash launches {launches}")
    return launches


SERVE_PROMPTS, SERVE_NEW = 4, 16


def serve_from_checkpoint_phase(torch, np, llama, dense_mod, save_dir) -> None:
    """Serving from a training checkpoint: ``InferenceEngine(checkpoint=)``
    in bf16 and woq8 on the checkpoint cell's tag (1 layer at Llama-3-8B
    widths), against engines built from ``zero_to_fp32``'s arrays of the
    same tag; then a 1-layer ``HybridEngine`` loads the tag (its cast
    invalidated) and generates. Gates: greedy tokens equal, the cast
    redone once after the load."""
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    from deepspeed_tpu_torch.config.config import load_config
    from deepspeed_tpu_torch.models.convert import params_from_numpy
    from deepspeed_tpu_torch.runtime.hybrid_engine import HybridEngine

    cfg = train_cfg(llama, CKPT_LAYERS)
    spec = llama.build(cfg)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (SERVE_PROMPTS, 32),
                                                 dtype=np.int32)
    out, tokens = {}, {}
    t0 = time.perf_counter()
    arrays = zero_to_fp32.get_fp32_state_dict_from_checkpoint(save_dir)
    z2f_s = time.perf_counter() - t0
    nested: dict = {}
    for name, arr in arrays.items():
        *path, leaf = name.split(".")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    for quant in ("off", "woq8"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        eng, load_ms = timed_ms(torch, lambda: dense_mod.InferenceEngine(
            spec, dtype=torch.bfloat16, checkpoint=save_dir, quant=quant))
        device_bytes = torch.cuda.memory_allocated() - base
        got = eng.generate(prompts, max_new_tokens=SERVE_NEW)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ref = dense_mod.InferenceEngine(spec, dtype=torch.bfloat16, quant=quant,
                                        params=params_from_numpy(nested, torch.bfloat16, "cuda"))
        want = ref.generate(prompts, max_new_tokens=SERVE_NEW)
        del ref
        tokens[quant] = got
        out[quant] = dict(load_s=load_ms / 1e3, device_bytes=device_bytes,
                          tokens_equal=bool(np.array_equal(got, want)),
                          in_vocab=bool(((got >= 0) & (got < cfg.vocab_size)).all()))
    del arrays, nested
    gc.collect()
    torch.cuda.empty_cache()
    config = load_config(dict(TRAIN_CONFIG))
    config.resolve_batch_sizes(1)
    hyb = HybridEngine(partial(llama.build, cfg), config, seed=2)
    hyb.generate(prompts, max_new_tokens=SERVE_NEW)  # on its own init
    casts = hyb.eval_casts
    hyb.load_checkpoint(save_dir, verify=False)
    hyb_tokens = hyb.generate(prompts, max_new_tokens=SERVE_NEW)
    hybrid = dict(casts_before_load=casts, casts_after=hyb.eval_casts,
                  tokens_equal_dense_from_tag=bool(np.array_equal(hyb_tokens, tokens["off"])))
    hyb.destroy()
    del hyb
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_from_checkpoint", model="llama3_8b widths", layers=CKPT_LAYERS,
         dtype="bfloat16", prompts=[SERVE_PROMPTS, 32], new_tokens=SERVE_NEW,
         source="deepspeed_tpu/inference/engine.py:134-171", zero_to_fp32_s=z2f_s,
         engines=out, hybrid_load=hybrid, nvidia_smi=nvidia_smi("name", "power.limit"))
    bad = {q: r for q, r in out.items() if not (r["tokens_equal"] and r["in_vocab"])}
    if bad or hybrid["casts_after"] != casts + 1 or not hybrid["tokens_equal_dense_from_tag"]:
        raise AssertionError(f"serve_from_checkpoint: {bad or out}, hybrid {hybrid}")


HYBRID_PROMPTS, HYBRID_NEW = 4, 16


def hybrid_phase(torch, np, llama, dense_mod) -> None:
    """``HybridEngine`` on the 4-layer training cell: one ``train_batch``,
    then greedy ``generate`` (twice) and seeded rollouts. Gates: tokens equal
    a dense engine given ``eval_params``; one cast for the step."""
    from deepspeed_tpu_torch.config.config import load_config
    from deepspeed_tpu_torch.runtime.hybrid_engine import HybridEngine

    cfg = train_cfg(llama, TRAIN_LAYERS)
    config = load_config(dict(TRAIN_CONFIG))
    config.resolve_batch_sizes(1)
    gc.collect()
    torch.cuda.empty_cache()
    hyb = HybridEngine(partial(llama.build, cfg), config, seed=0)
    rng = np.random.default_rng(13)
    loss = float(hyb.train_batch({"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)}))
    prompts = rng.integers(0, cfg.vocab_size, (HYBRID_PROMPTS, 64), dtype=np.int32)
    (full, lps), first_ms = timed_ms(torch, lambda: hyb.generate(
        prompts, max_new_tokens=HYBRID_NEW, return_logprobs=True))
    again, repeat_ms = timed_ms(torch, lambda: hyb.generate(prompts, max_new_tokens=HYBRID_NEW))
    rolls = hyb.generate_rollouts(list(prompts[:2]) + [prompts[2, :48]], rollout_batch_size=2,
                                  max_new_tokens=8, temperature=0.8, seed=5)
    casts = hyb.eval_casts
    dense = dense_mod.InferenceEngine(llama.build(cfg), dtype=torch.bfloat16,
                                      params=hyb.eval_params)
    want = dense.generate(prompts, max_new_tokens=HYBRID_NEW)
    shared = all(dense.params["layers"][k].data_ptr() == v.data_ptr()
                 for k, v in hyb.eval_params["layers"].items())
    captures = hyb.programs.captures
    del dense
    hyb.destroy()
    del hyb
    gc.collect()
    torch.cuda.empty_cache()
    equal = bool(np.array_equal(full, want) and np.array_equal(again, full))
    emit("hybrid", model="llama3_8b widths", layers=TRAIN_LAYERS, loss=loss,
         source="deepspeed_tpu/runtime/hybrid_engine.py", prompts=[HYBRID_PROMPTS, 64],
         new_tokens=HYBRID_NEW, first_generate_ms=first_ms, repeat_generate_ms=repeat_ms,
         eval_casts=casts, graph_captures=captures, tokens_equal_dense=equal,
         dense_shares_eval_params=shared, logprobs_finite=bool(np.isfinite(lps).all()),
         rollout_lengths=[len(r["tokens"]) for r in rolls],
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if not (equal and casts == 1 and shared and np.isfinite(lps).all()
            and [len(r["tokens"]) for r in rolls] == [8, 8, 8]):
        raise AssertionError(f"hybrid: tokens equal {equal}, casts {casts}, shared {shared}")


# bench.py:_train_chaos_impl's legs, all but the pipeline one (ROADMAP.md
# queue 1 item 12): each a thread, its workers (runtime/chaos.py's worker as
# ``python -m deepspeed_tpu_torch.runtime.chaos``) processes one after another
CHAOS_LEGS = ("reference", "kills", "elastic", "sentinel", "wedge")


class ChaosLegs:
    """The legs' state: the worker module, its launches and their timing."""

    def __init__(self, root: str, seed: int, device):
        from deepspeed_tpu_torch.runtime import chaos

        self.chaos, self.root, self.seed, self.device = chaos, root, seed, device
        self.repo = os.path.dirname(os.path.abspath(__file__))

    def env(self, work_dir, faults=None, sentinel=False, total=None, save_every=2) -> dict:
        c = self.chaos
        env = dict(os.environ)
        env["PYTHONPATH"] = self.repo + (os.pathsep + env["PYTHONPATH"]
                                         if env.get("PYTHONPATH") else "")
        env.update(CHAOS_DIR=work_dir, CHAOS_TOTAL_STEPS=str(total or c.TOTAL_STEPS),
                   CHAOS_SAVE_EVERY=str(save_every), CHAOS_SEED=str(self.seed),
                   CHAOS_FAULTS=json.dumps(faults or []))
        env.pop("CHAOS_SENTINEL", None)
        # a worker is a world of its own: never a rank of the caller's group
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        if sentinel:
            env["CHAOS_SENTINEL"] = "1"
        if self.device is not None:
            env["CHAOS_DEVICE"] = str(self.device)
        return env

    def cmd(self) -> list:
        return [sys.executable, "-m", "deepspeed_tpu_torch.runtime.chaos"]

    def run(self, work_dir, label, faults=None, kill_after=None, **env_kw) -> int:
        """One worker run; the exit code (negative: a signal)."""
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, f"{label}.log"), "ab") as log:
            proc = subprocess.Popen(self.cmd(), env=self.env(work_dir, faults, **env_kw),
                                    stdout=log, stderr=log, cwd=self.repo)
            try:
                if kill_after is not None:
                    try:
                        proc.wait(timeout=kill_after)
                    except subprocess.TimeoutExpired:
                        proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return proc.returncode


def _reference_leg(L: ChaosLegs) -> dict:
    c = L.chaos
    d = os.path.join(L.root, "ref")
    rc = L.run(d, "ref")
    traj = {r["step"]: r["loss"] for r in c.read_jsonl(os.path.join(d, "trajectory.jsonl"))}
    return {"rc": rc, "trajectory": traj}


def _kill_leg(L: ChaosLegs) -> dict:
    rng = random.Random(L.seed)
    d = os.path.join(L.root, "chaos")
    attempts = [
        ("kill@ckpt.flush", [{"point": "ckpt.flush", "kind": "kill",
                              "after": 3 + rng.randrange(3)}], None),
        ("kill@ckpt.collect", [{"point": "ckpt.collect", "kind": "kill", "after": 1}], None),
        ("kill@ckpt.commit", [{"point": "ckpt.commit", "kind": "kill",
                               "after": rng.randrange(2)}], None),
        ("kill@ckpt.latest", [{"point": "ckpt.latest", "kind": "kill",
                               "after": rng.randrange(2)}], None),
        ("kill@timer", None, 4.0 + 6.0 * rng.random()),
        ("corrupt@ckpt.load", [{"point": "ckpt.load", "kind": "corrupt-bytes",
                                "times": 1}], None),
    ]
    runs, kills = [], []
    for i, (label, faults, kill_after) in enumerate(attempts):
        rc = L.run(d, f"attempt{i}", faults=faults, kill_after=kill_after)
        runs.append({"label": label, "rc": rc})
        if rc is not None and rc < 0:
            kills.append(label)
    extra = 0
    while runs[-1]["rc"] != 0 and extra < 5:
        extra += 1
        runs.append({"label": f"clean{extra}", "rc": L.run(d, f"extra{extra}")})
    return {"runs": runs, "kills": kills, "dir": d}


def _elastic_leg(L: ChaosLegs) -> dict:
    from deepspeed_tpu_torch.elasticity.agent import ElasticAgent, WorkerSpec

    d = os.path.join(L.root, "elastic")
    os.makedirs(d, exist_ok=True)

    def make_worker(rank, world):
        if rank == 0:
            return WorkerSpec(cmd=L.cmd(), env=L.env(d))
        # a slot that is evicted once: at the smaller world it is never filled again
        return WorkerSpec(cmd=[sys.executable, "-c",
                               "import time,sys; time.sleep(6); sys.exit(3)"])

    agent = ElasticAgent(target_batch_size=4, micro_batch_candidates=[2, 4],
                         make_worker=make_worker, max_world_size=2, min_world_size=1,
                         poll_interval=0.3, max_restarts=3)
    rc = agent.run()
    return {"rc": rc, "restarts": agent.restarts, "world": agent.world_size, "dir": d}


def _sentinel_leg(L: ChaosLegs) -> dict:
    from deepspeed_tpu_torch.runtime import sentinel as sentinel_mod

    c = L.chaos
    poison_fp = sentinel_mod.batch_fingerprint(c.batch_for(10))
    chaos = os.path.join(L.root, "sent_chaos")
    rc = L.run(chaos, "sent_chaos", faults=[
        {"point": "train.grads", "kind": "nan-grads", "after": 6, "times": 1},
        {"point": "data.batch", "kind": "poison-batch", "request_id": poison_fp, "times": 1},
    ], sentinel=True, total=c.SENT_TOTAL, save_every=c.SENT_SAVE)
    quarantine = sentinel_mod.load_quarantine(os.path.join(chaos, "state"))
    ref = os.path.join(L.root, "sent_ref")
    os.makedirs(os.path.join(ref, "state"), exist_ok=True)
    sentinel_mod.save_quarantine(os.path.join(ref, "state"), quarantine)
    ref_rc = L.run(ref, "sent_ref", sentinel=True, total=c.SENT_TOTAL,
                   save_every=c.SENT_SAVE)
    return {"rc": rc, "ref_rc": ref_rc, "chaos": chaos, "ref": ref, "quarantine": quarantine}


def _wedge_leg(L: ChaosLegs) -> dict:
    from deepspeed_tpu_torch.elasticity.agent import ElasticAgent, WorkerSpec

    c = L.chaos
    d = os.path.join(L.root, "wedge")
    os.makedirs(d, exist_ok=True)
    armed = {"first": True}

    def make_worker(rank, world):
        faults = []
        if armed["first"]:  # only the first incarnation: the relaunch runs clean
            armed["first"] = False
            faults = [{"point": "train.dispatch", "kind": "wedge", "delay_s": 600.0,
                       "after": 4, "times": 1}]
        return WorkerSpec(cmd=L.cmd(), env=L.env(d, faults, sentinel=True, total=c.WEDGE_TOTAL,
                                                save_every=c.WEDGE_SAVE))

    agent = ElasticAgent(target_batch_size=4, micro_batch_candidates=[2, 4],
                         make_worker=make_worker, max_world_size=1, min_world_size=1,
                         poll_interval=0.5, max_restarts=3,
                         heartbeat_dir=os.path.join(d, "state"), heartbeat_timeout=5.0,
                         heartbeat_grace=60.0)
    rc = agent.run()
    return {"rc": rc, "restarts": agent.restarts, "kills": agent.heartbeat_kills, "dir": d}


_LEG_FNS = {"reference": _reference_leg, "kills": _kill_leg, "elastic": _elastic_leg,
            "sentinel": _sentinel_leg, "wedge": _wedge_leg}


def _max_rel(got: dict, want: dict, steps) -> float:
    worst = 0.0
    for s in steps:
        a, b = got.get(s), want.get(s)
        if a is None or b is None or a != a or b != b:
            return float("inf")
        worst = max(worst, abs(a - b) / max(1e-12, abs(b)))
    return worst


def train_chaos_legs(root: str, device=None, seed: int = 0) -> dict:
    """Run the legs at once (a thread each) under ``root``; returns
    ``{"ok", "checks", "seconds", "recover_*", ...}``. The work dirs are
    removed when every check holds."""
    # the legs' imports, before their threads start: a first import of torch
    # from several threads at once can abort the process
    import deepspeed_tpu_torch.elasticity.agent  # noqa: F401
    import deepspeed_tpu_torch.runtime.sentinel  # noqa: F401

    L = ChaosLegs(root, seed, device)
    c, legs = L.chaos, CHAOS_LEGS
    total_steps = c.TOTAL_STEPS
    os.makedirs(root, exist_ok=True)
    results, errors, seconds = {}, {}, {}

    def run_leg(name):
        t0 = time.perf_counter()
        try:
            results[name] = _LEG_FNS[name](L)
        except Exception as e:  # noqa: BLE001 - a failed leg fails its checks
            errors[name] = f"{type(e).__name__}: {e}"
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run_leg, args=(n,), name=f"chaos-{n}") for n in legs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    checks: dict = {}
    out: dict = {"legs": list(legs), "errors": errors, "seconds": seconds}
    reference = results.get("reference", {}).get("trajectory", {})
    if "reference" in legs:
        checks["reference_complete"] = (results.get("reference", {}).get("rc") == 0
                                        and len(reference) == total_steps)
    if "kills" in legs:
        r = results.get("kills")
        if r is None:
            checks["completed"] = False
        else:
            status = c.read_jsonl(os.path.join(r["dir"], "status.jsonl"))
            saves = [s for s in status if s["event"] == "saved"]
            resumes = [s for s in status if s["event"] == "resume"]
            fresh = [s for s in status if s["event"] == "fresh"]
            exhausted = [s for s in status if s["event"] == "exhausted"]
            first_save_at = status.index(saves[0]) if saves else len(status)
            late_fresh = [s for s in fresh if status.index(s) > first_save_at]
            completed = r["runs"][-1]["rc"] == 0
            fallbacks = [s for s in resumes if s.get("latest") and s.get("tag") != s.get("latest")]
            by_step: dict = {}
            for rec in c.read_jsonl(os.path.join(r["dir"], "trajectory.jsonl")):
                by_step.setdefault(rec["step"], []).append(rec["loss"])
            full = sorted(by_step) == list(range(total_steps))
            max_rel = max((_max_rel({0: v}, {0: reference.get(s)}, [0])
                           for s, vs in by_step.items() for v in vs), default=float("inf"))
            out["recover_kills"] = c.recoveries(r["dir"])
            checks.update(completed=completed,
                          always_loadable=completed and not late_fresh and not exhausted,
                          kills_ge_3=len(r["kills"]) >= 3,
                          killed_mid_commit="kill@ckpt.commit" in r["kills"],
                          full_coverage=full, trajectory_parity=full and max_rel <= 1e-5,
                          fallback_observed=bool(fallbacks))
            out.update(runs=r["runs"], kills=r["kills"], saves=len(saves),
                       resumes=len(resumes), fallbacks=len(fallbacks), max_rel_loss_diff=max_rel)
    if "elastic" in legs:
        r = results.get("elastic")
        if r is None:
            checks.update(elastic_ok=False, elastic_world_reduced=False)
        else:
            traj = c.read_jsonl(os.path.join(r["dir"], "trajectory.jsonl"))
            parity = all(abs(x["loss"] - reference[x["step"]])
                         <= 1e-5 * max(1e-12, abs(reference[x["step"]]))
                         for x in traj if x["step"] in reference)
            checks["elastic_ok"] = (r["rc"] == 0 and {x["step"] for x in traj}
                                    == set(range(total_steps)) and parity and bool(reference))
            checks["elastic_world_reduced"] = r["world"] == 1
            out.update(elastic_agent_rc=r["rc"], elastic_agent_restarts=r["restarts"],
                       elastic_agent_world=r["world"], recover_elastic=c.recoveries(r["dir"]))
    if "sentinel" in legs:
        r = results.get("sentinel")
        if r is None:
            checks.update(sentinel_self_heals=False, sentinel_quarantined_two=False,
                          sentinel_one_rollback=False, sentinel_stitched_parity=False,
                          sentinel_forensics=False)
        else:
            status = c.read_jsonl(os.path.join(r["chaos"], "status.jsonl"))
            rollbacks = [s for s in status if s["event"] == "rollback"]
            chaos_last = {x["step"]: x["loss"]
                          for x in c.read_jsonl(os.path.join(r["chaos"], "trajectory.jsonl"))}
            ref_last = {x["step"]: x["loss"]
                        for x in c.read_jsonl(os.path.join(r["ref"], "trajectory.jsonl"))}
            max_rel = _max_rel(chaos_last, ref_last, range(c.SENT_TOTAL))
            bitwise = all(chaos_last.get(s) == ref_last.get(s) for s in range(c.SENT_TOTAL))
            rdir = os.path.join(r["chaos"], "reports")
            reports = sorted(os.listdir(rdir)) if os.path.isdir(rdir) else []
            checks.update(
                sentinel_self_heals=r["rc"] == 0 and any(s["event"] == "done" for s in status),
                sentinel_quarantined_two=len(r["quarantine"]) == 2,
                sentinel_one_rollback=len(rollbacks) == 1,
                sentinel_stitched_parity=(r["ref_rc"] == 0 and set(chaos_last)
                                          == set(range(c.SENT_TOTAL)) and max_rel <= 1e-5),
                sentinel_forensics=any(n.startswith("sentinel_rollback") for n in reports))
            out.update(sentinel_rollbacks=len(rollbacks), sentinel_quarantined=r["quarantine"],
                       sentinel_reports=reports, sentinel_max_rel_loss_diff=max_rel,
                       sentinel_stitched_bitwise=bitwise,
                       sentinel_rollback_s=[s.get("seconds") for s in rollbacks])
    if "wedge" in legs:
        r = results.get("wedge")
        if r is None:
            checks["wedge_heartbeat_kill"] = False
        else:
            status = c.read_jsonl(os.path.join(r["dir"], "status.jsonl"))
            checks["wedge_heartbeat_kill"] = (r["rc"] == 0 and r["kills"] >= 1
                                              and r["restarts"] >= 1
                                              and any(s["event"] == "done" for s in status))
            out.update(wedge_heartbeat_kills=r["kills"], wedge_agent_rc=r["rc"],
                       wedge_agent_restarts=r["restarts"], recover_wedge=c.recoveries(r["dir"]))
    out["checks"] = checks
    out["ok"] = bool(checks) and all(checks.values()) and not errors
    if out["ok"]:
        shutil.rmtree(root, ignore_errors=True)
    return out


def train_chaos_start():
    """The legs on the card in a thread, using the libraries built above.
    Returns the thread, the dict it fills and the ``t_s`` it started at;
    until ``train_chaos_finish`` every phase line carries
    ``beside_train_chaos``."""
    import tempfile

    result: dict = {}
    root = tempfile.mkdtemp(prefix="dstpu-train-chaos-chip-smoke-")

    def run():
        t0 = time.perf_counter()
        try:
            result.update(train_chaos_legs(root, seed=0))
        except Exception as e:  # noqa: BLE001 - reported by train_chaos_finish
            result["error"] = f"{type(e).__name__}: {e}"
        result["wall_s"] = time.perf_counter() - t0
        result["root"] = root

    started_t_s = time.perf_counter() - _START
    thread = threading.Thread(target=run, name="train-chaos")
    thread.start()
    BESIDE["beside_train_chaos"] = True
    return thread, result, started_t_s


def train_chaos_finish(thread, result, started_t_s: float) -> None:
    """Wait for the legs, print their line, gate every check."""
    thread.join(timeout=600)
    BESIDE.clear()
    emit("train_chaos", source="bench.py:2347-2880", started_at_t_s=started_t_s,
         worker_config="hidden 32, 1 layer, vocab 97, seq 32, batch 4, 10 steps, save every 2",
         left_out="the pipeline leg (pipe_stage_killed, pipe_stitched_parity): ROADMAP.md "
                  "queue 1 item 12", alive_after_600_s=thread.is_alive(),
         **{k: v for k, v in result.items() if k != "root"},
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if thread.is_alive() or not result.get("ok"):
        failed = sorted(k for k, v in result.get("checks", {}).items() if not v)
        raise AssertionError(f"train_chaos: failed checks {failed}, errors "
                             f"{result.get('errors')} {result.get('error')} (work dir "
                             f"{result.get('root')})")
    shutil.rmtree(result["root"], ignore_errors=True)


# ------------------------------------------------- the HTTP serving tier
# bench.py:serving_bench_main's accelerator branch (:1153-1157): 48
# requests of 48 new tokens, Poisson arrivals at 8/s, prompts of
# 64/128/256/512 tokens from default_rng(0), greedy, SSE, through
# build_server with max_queue_tokens=2048 (:1238)
SERVING = dict(n_req=48, max_new=48, rate=8.0, prompt_lens=(64, 128, 256, 512),
               max_queue_tokens=2048)
# the fp32 phases' watchdog (bench.py:2212-2213) and the chaos bench's
# schedule, verbatim (bench.py:2237-2250): a transient dispatch raise, a
# readback hang, a four-raise dispatch burst and an allocation fault
# bench.py:2208-2213's chaos engine (its sizes and fused config, the
# watchdog); here at Llama-3-8B's widths, 2 layers, fp32. Its 3 slots and
# 16-token budget spread 8 requests over enough dispatches for the
# schedule's burst to land (on engine_fused's sizes they finish in fewer)
CHAOS_ENGINE = dict(max_tokens_per_step=16, max_seqs=3, block_size=4, num_blocks=49,
                    max_blocks_per_seq=16, decode_run_ahead=4, prefill_tile=8, fused_chunk=4,
                    pipeline_depth=2, device_state=True, dispatch_retries=2,
                    retry_backoff_s=0.01, degrade_after=2)
CHAOS_SCHEDULE = [
    {"point": "engine.dispatch", "kind": "raise", "after": 1},
    {"point": "engine.readback", "kind": "hang", "after": 6, "delay_s": 0.01},
    {"point": "engine.dispatch", "kind": "raise", "after": 10, "times": 4},
    {"point": "engine.alloc", "kind": "raise", "after": 2},
]
CHAOS_REQ, CHAOS_NEW = 8, 8
PARITY_REQ = 16
CLUSTER_PREFIX = 64
SERVING_TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def http_json(host, port, method, path, body=None, headers=None, timeout=300):
    """(status, headers, body bytes) of one HTTP request."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def completion(fe, body, headers=None) -> dict:
    """One completion through the frontend: status, tokens, finish reason,
    the response's traceparent, and for a stream the arrival time of each
    token (perf_counter) and the send time."""
    from deepspeed_tpu_torch.serving import decode_sse

    t_send = time.perf_counter()
    if not body.get("stream"):
        status, hdrs, raw = http_json(fe.host, fe.port, "POST", "/v1/completions", body, headers)
        rec = dict(status=status, traceparent=hdrs.get("traceparent"), t_send=t_send)
        if status == 200:
            choice = json.loads(raw)["choices"][0]
            rec.update(tokens=choice["tokens"], finish=choice["finish_reason"])
        return rec
    import http.client

    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=300)
    rec = dict(t_send=t_send, token_times=[], tokens=[])
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        rec.update(status=resp.status, traceparent=resp.getheader("traceparent"))
        if resp.status != 200:
            resp.read()
            return rec
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data:"):
                continue
            frame = decode_sse(line + b"\n")[0]
            if frame == "[DONE]":
                break
            if "token" in frame:
                rec["token_times"].append(time.perf_counter())
                rec["tokens"].append(frame["token"])
            elif "choices" in frame:
                rec["finish"] = frame["choices"][0]["finish_reason"]
                rec["final_tokens"] = frame["choices"][0]["tokens"]
    finally:
        conn.close()
    return rec


def concurrent(fn, items, stagger_s: float = 0.0, gaps=None) -> list:
    """``fn(item)`` for each item on its own thread, started ``stagger_s``
    apart (or at the cumulative ``gaps``, an open-loop schedule): results
    in item order."""
    import threading

    out = [None] * len(items)
    threads = []
    t0 = time.perf_counter()
    at = 0.0
    for i, item in enumerate(items):
        at += gaps[i] if gaps is not None else (stagger_s if i else 0.0)
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

        def one(i=i, item=item):
            out[i] = fn(item)

        th = threading.Thread(target=one, daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a request thread hung")
    return out


def metric_value(page: str, name: str) -> float | None:
    for line in page.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{}"):
            return float(line.split()[-1])
    return None


class SyncCounter:
    """Counts ``torch.cuda.synchronize`` calls and CUDA event waits (each
    engine readback is one) while installed."""

    def __init__(self, torch):
        self.torch = torch
        self.syncs = self.waits = 0
        self._sync, self._wait = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def __enter__(self):
        counter = self

        def sync(*a, **k):
            counter.syncs += 1
            return counter._sync(*a, **k)

        def wait(ev):
            counter.waits += 1
            return counter._wait(ev)

        self.torch.cuda.synchronize, self.torch.cuda.Event.synchronize = sync, wait
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize, self.torch.cuda.Event.synchronize = self._sync, self._wait


def serving_phase(torch, np, pa, eng) -> dict:
    """``bench.py:serving_bench_main`` on the card: engine_fused's engine
    (Llama-3-8B, full depth, bf16, warmed) behind ``build_server`` with
    telemetry on (JSONL under runs/), an open-loop Poisson client streaming
    SSE. TTFT, decode latency, 429s and goodput beside the card; gates: every
    admitted request 200 with 48 tokens in the vocabulary, no capture and
    every dispatch a replay, both paged kernels launched, /healthz ready,
    /metrics' request count, a clean drain with no leaked block. Its tokens
    against the engine's own ``generate_all()`` are counted (bf16 streams of
    differently batched runs diverge). Returns the paged kernels' launches."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.serving import RouterConfig, build_server

    vocab = int(eng.params["embed"].shape[0])
    n_req, max_new, rate = SERVING["n_req"], SERVING["max_new"], SERVING["rate"]
    lens = SERVING["prompt_lens"]
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, (0,), dtype=np.int32).tolist()
    prompts = [prefix + rng.integers(0, vocab, (int(lens[i % len(lens)]),),
                                     dtype=np.int32).tolist() for i in range(n_req)]
    rng.shuffle(prompts)
    gaps = rng.exponential(1.0 / rate, n_req)
    os.makedirs("runs", exist_ok=True)
    jsonl = os.path.join("runs", f"serving-chip-smoke-{os.getpid()}.jsonl")
    telemetry.configure(enabled=True, jsonl_path=jsonl)
    p0 = eng.programs
    before = dict(captures=p0.captures, eager=p0.eager_runs, replays=p0.replays,
                  dispatches=eng.dispatch_count, forwards=eng.forwards)
    pa.reset_counts()
    fe, router, loops = build_server([eng], router_cfg=RouterConfig(
        max_queue_tokens=SERVING["max_queue_tokens"]))
    sampler = PowerSampler()
    try:
        t0 = time.perf_counter()
        recs = concurrent(lambda p: completion(fe, {"prompt": p, "max_tokens": max_new,
                                                    "stream": True}), prompts, gaps=gaps)
        wall = time.perf_counter() - t0
        _, _, raw = http_json(fe.host, fe.port, "GET", "/healthz")
        health = json.loads(raw)
        _, _, page = http_json(fe.host, fe.port, "GET", "/metrics")
        page = page.decode()
    finally:
        power = sampler.stop()
        drained = fe.drain(timeout=120)
        telemetry.TELEMETRY.close()
    launches, plain_calls = launch_counts(pa)
    d = dict(captures=p0.captures - before["captures"], eager=p0.eager_runs - before["eager"],
             replays=p0.replays - before["replays"],
             dispatches=eng.dispatch_count - before["dispatches"],
             forwards=eng.forwards - before["forwards"])
    done = [r for r in recs if r["status"] == 200]
    rejected = sum(r["status"] == 429 for r in recs)
    ttfts = sorted(r["token_times"][0] - r["t_send"] for r in done if r["token_times"])
    gaps_s = [b - a for r in done for a, b in zip(r["token_times"], r["token_times"][1:])]
    useful = sum(len(p) + len(r["tokens"]) for p, r in zip(prompts, recs) if r["status"] == 200)
    served = metric_value(page, "inference_requests_total")
    # the same prompts through the engine's own generate_all (counted only)
    for i, p in enumerate(prompts):
        eng.put(("own", i), p, max_new_tokens=max_new)
    own = eng.generate_all()
    same = sum(r["tokens"] == own[("own", i)] for i, r in enumerate(recs) if r["status"] == 200)
    leaked = eng.allocator.free_blocks != eng.cfg.num_blocks - 1
    with open(jsonl) as f:
        jsonl_records = sum(1 for _ in f)
    os.remove(jsonl)

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None

    emit("serving", model="llama3_8b", dtype="bfloat16", source="bench.py:1127-1357",
         stack="HTTP frontend -> router -> EngineLoop -> ragged engine (engine_fused's)",
         requests=n_req, new_tokens_each=max_new, arrival_rate_per_s=rate,
         completed=len(done), rejected_429=rejected, wall_s=wall,
         ttft_p50_s=pct(ttfts, 0.5), ttft_p99_s=pct(ttfts, 0.99),
         decode_latency_mean_s=sum(gaps_s) / len(gaps_s) if gaps_s else None,
         goodput_tokens_per_s=useful / wall, dispatches=d["dispatches"], forwards=d["forwards"],
         graph_replays=d["replays"], graph_captures=d["captures"], eager_runs=d["eager"],
         kernel_launches=launches, plain_version_calls=plain_calls,
         metrics_inference_requests_total=served, healthz=health.get("status"),
         drained=drained, leaked=leaked, telemetry_jsonl_records=jsonl_records,
         streams_equal_to_generate_all=same, streams_compared=len(done),
         nvidia_smi=nvidia_smi("name", "power.limit"), **power)
    bad = [i for i, r in enumerate(recs) if r["status"] == 200 and (
        len(r["tokens"]) != max_new or r.get("finish") != "length"
        or any(not 0 <= t < vocab for t in r["tokens"]))]
    if bad or any(r["status"] not in (200, 429) for r in recs) or not done:
        raise AssertionError(f"serving: requests {bad} (or a non-200/429 status) failed")
    if d["captures"] or d["eager"] or d["replays"] != d["dispatches"]:
        raise AssertionError(f"serving: {d['captures']} captures and {d['eager']} eager runs; "
                             f"{d['replays']} replays of {d['dispatches']} dispatches")
    if min(launches.values()) <= 0 or plain_calls:
        raise AssertionError(f"serving: kernel launches {launches}, plain calls {plain_calls}")
    if health.get("status") != "ready":
        raise AssertionError(f"serving: /healthz said {health.get('status')} before the drain")
    if served != len(done):
        raise AssertionError(f"serving: /metrics counted {served} requests, {len(done)} done")
    if not drained or leaked:
        raise AssertionError(f"serving: drained {drained}, blocks leaked {leaked}")
    return launches


def parity_requests(np, vocab, n=PARITY_REQ):
    """The first n prompts of the serving workload, half greedy and half
    seeded: (uid, prompt, sampling controls)."""
    out = []
    for i, p in enumerate(requests(np, vocab)[:n]):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_k=20, seed=1000 + i)
        out.append((f"p{i}", p.tolist(), kw))
    return out


def host_tokens(ragged, spec, params, reqs, max_new) -> dict:
    """The host-staged engine's tokens (fp32): the fp32 phases' reference."""
    import torch

    host = ragged.RaggedInferenceEngine(spec, ragged.RaggedConfig(**ENGINE, device_state=False),
                                        dtype=torch.float32, params=params)
    for uid, p, kw in reqs:
        host.put(uid, p, max_new_tokens=max_new, **kw)
    out = host.generate_all()
    del host
    return out


def fused32_engine(torch, ragged, spec, params):
    """The bench's fused config in fp32 with the prefix cache on, warmed for
    greedy and for seeded top-k batches."""
    eng = ragged.RaggedInferenceEngine(
        spec, ragged.RaggedConfig(**ENGINE, **FUSED, enable_prefix_cache=True),
        dtype=torch.float32, params=params)
    eng.warmup()
    eng.warmup(sampled=True, has_tk=True)
    return eng


def serving_parity_phase(torch, np, llama, ragged, params32):
    """fp32, 2 layers at full width: the fused engine run directly twice,
    telemetry off then on, with ``reset_state()`` between (same tokens,
    dispatches, readbacks and synchronize calls; the tensors the graphs
    hold unmoved), then 16 requests (half seeded) through HTTP: the tokens
    equal the host-staged engine's, and a client traceparent comes back
    with the request's engine spans under it in /debug/trace. Returns the
    engine and the host-staged reference."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.inference.kvquant import kv_leaves
    from deepspeed_tpu_torch.serving import RouterConfig, build_server

    cfg, params = params32
    spec = llama.build(cfg)
    reqs = parity_requests(np, cfg.vocab_size)
    ref = host_tokens(ragged, spec, params, reqs, MAX_NEW)
    eng = fused32_engine(torch, ragged, spec, params)

    def pointers():
        ts = [x for name in ("k", "v") for x in kv_leaves(eng.cache[name])]
        ts += [*eng._dev_state, eng._bt_dev, eng._slot_toks]
        return [t.data_ptr() for t in ts]

    runs = []
    ptr0 = pointers()
    for on in (False, True):
        telemetry.TELEMETRY.reset()
        if on:
            telemetry.configure(enabled=True, tracing=True, slo=True)
        disp0, replays0 = eng.dispatch_count, eng.programs.replays
        with SyncCounter(torch) as sc:
            for uid, p, kw in reqs:
                eng.put(uid, p, max_new_tokens=MAX_NEW, **kw)
            out = eng.generate_all()
        runs.append(dict(tokens={u: out[u] for u, _, _ in reqs},
                         dispatches=eng.dispatch_count - disp0,
                         replays=eng.programs.replays - replays0, readbacks=sc.waits,
                         synchronize_calls=sc.syncs))
        eng.reset_state()  # the next run starts cold: no prefix hits
    telemetry.TELEMETRY.reset()
    in_place = pointers() == ptr0
    counts_equal = {k: runs[0][k] == runs[1][k] for k in runs[0]}

    telemetry.configure(enabled=True, tracing=True)
    captures0 = eng.programs.captures
    # the loop starts once every request waits in its inbox, whose
    # priorities (i - 8) are the put order of the reference's run: the
    # batches are then those of the direct runs, whatever the HTTP threads'
    # order (a different batch composition may round an fp32 near-tie
    # otherwise)
    fe, router, loops = build_server([eng], start=False,
                                     router_cfg=RouterConfig(max_queue_tokens=1 << 20))
    fe.start()

    def start_when_queued():
        for _ in range(6000):
            if loops[0].stats().queued >= len(reqs):
                break
            time.sleep(0.005)
        loops[0].start()

    import threading

    starter = threading.Thread(target=start_when_queued, daemon=True)
    starter.start()
    try:
        recs = concurrent(lambda r: completion(
            fe, {"prompt": r[1], "max_tokens": MAX_NEW, "stream": r[0][-1] in "13579",
                 "priority": int(r[0][1:]) - 8, **r[2]},
            headers={"traceparent": SERVING_TRACEPARENT} if r[0] == "p0" else None), reqs)
        starter.join()
        trace_id = SERVING_TRACEPARENT.split("-")[1]
        _, _, raw = http_json(fe.host, fe.port, "GET", f"/debug/trace?trace_id={trace_id}")
        names = [e["name"] for e in json.loads(raw)["traceEvents"]]
    finally:
        drained = fe.drain(timeout=120)
        telemetry.TELEMETRY.reset()
    got = {uid: r.get("tokens") for (uid, _, _), r in zip(reqs, recs)}
    echoed = (recs[0].get("traceparent") or "").split("-")[1:2] == [trace_id]
    emit("serving_parity", model="llama3_8b widths, 2 layers", dtype="float32",
         requests=len(reqs), seeded=sum(bool(kw) for _, _, kw in reqs),
         http_tokens_equal_host_staged=got == ref,
         http_streams_differing=sorted(u for u in ref if got.get(u) != ref[u]),
         direct_tokens_equal_host_staged=[r["tokens"] == ref for r in runs],
         telemetry_off=runs[0] | {"tokens": None}, telemetry_on=runs[1] | {"tokens": None},
         counts_equal_with_telemetry_on=counts_equal,
         reset_state_in_place=in_place, traceparent_echoed=echoed,
         trace_span_names=sorted(set(names)), engine_request_spans=names.count("engine/request"),
         captures_while_serving=eng.programs.captures - captures0, drained=drained,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if got != ref or any(r["tokens"] != ref for r in runs):
        raise AssertionError("serving_parity: tokens differ from the host-staged engine's")
    if not all(counts_equal.values()):
        raise AssertionError(f"serving_parity: telemetry changed the device work: {runs}")
    if not in_place:
        raise AssertionError("serving_parity: reset_state() moved a graph-held tensor")
    if not echoed or names.count("engine/request") != 1 or "http/request" not in names:
        raise AssertionError(f"serving_parity: trace not propagated: {sorted(set(names))}")
    if not drained or eng.programs.captures != captures0:
        raise AssertionError("serving_parity: captures while serving, or no clean drain")
    return eng, ref


def serving_cluster_phase(torch, np, llama, ragged, params32, prefill):
    """fp32, 2 layers at full width: ``build_cluster_server`` over the
    parity engine (prefill) and a second engine sharing its weights
    (decode); 8 requests on two shared 64-token prefixes, greedy and seeded,
    every one handed off; tokens equal one (host-staged) engine's, the
    cluster prefix index hits, the drain runs begin_drain -> join -> close.
    Returns the decode engine."""
    from deepspeed_tpu_torch.serving import build_cluster_server

    cfg, params = params32
    spec = llama.build(cfg)
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(0, cfg.vocab_size, CLUSTER_PREFIX).tolist() for _ in range(2)]
    reqs = [(f"c{i}", prefixes[i % 2] + rng.integers(0, cfg.vocab_size, 16 + 8 * i).tolist(),
             {} if i % 4 < 2 else dict(temperature=0.8, top_k=20, seed=2000 + i))
            for i in range(8)]
    ref = host_tokens(ragged, spec, params, reqs, MAX_NEW)
    decode = fused32_engine(torch, ragged, spec, params)
    fe, cluster, loops = build_cluster_server([prefill], [decode])
    order = []
    try:
        one = lambda r: completion(fe, {"prompt": r[1], "max_tokens": MAX_NEW,  # noqa: E731
                                        "stream": r[0][-1] in "1357", **r[2]})
        recs = [one(r) for r in reqs[:2]]  # one a prefix first: the index learns both
        recs += concurrent(one, reqs[2:])
        for _ in range(500):
            st = cluster.cluster_stats()
            if st["handoffs"]["ok"] + st["handoffs"]["failed"] >= len(reqs):
                break
            time.sleep(0.01)
    finally:
        cluster.begin_drain()
        order.append("begin_drain")
        joined = all(lp.join(timeout=120) for lp in loops)
        order.append("join")
        fe.close()
        order.append("close")
    got = {uid: r.get("tokens") for (uid, _, _), r in zip(reqs, recs)}
    clean = all(e.allocator.free_blocks == e.cfg.num_blocks - 1 and not e.has_work
                for e in (prefill, decode))
    emit("serving_cluster", model="llama3_8b widths, 2 layers", dtype="float32",
         requests=len(reqs), prefix_tokens=CLUSTER_PREFIX, tokens_equal_one_engine=got == ref,
         handoffs=st["handoffs"], prefix_index=st["prefix_index"], fallbacks=st["fallbacks"],
         kv_transfer=st["kv_transfer"], drain_order=order, joined=joined, clean=clean,
         kv_blocks_exported=prefill.kv_blocks_exported,
         kv_blocks_imported=decode.kv_blocks_imported,
         nvidia_smi=nvidia_smi("name", "power.limit"))
    if got != ref:
        raise AssertionError("serving_cluster: disaggregated tokens differ from one engine's")
    if st["handoffs"]["ok"] != len(reqs) or st["handoffs"]["failed"] or st["fallbacks"]:
        raise AssertionError(f"serving_cluster: handoffs {st['handoffs']}, "
                             f"fallbacks {st['fallbacks']}")
    if st["prefix_index"]["hits"] <= 0:
        raise AssertionError(f"serving_cluster: no prefix-index hit: {st['prefix_index']}")
    if not joined or not clean:
        raise AssertionError(f"serving_cluster: joined {joined}, clean {clean}")
    return decode


def serving_chaos_phase(torch, np, llama, ragged, params32):
    """``bench.py:_chaos_bench_impl`` on the card, fp32, 2 layers at full
    width: its fault schedule on its engine (``CHAOS_ENGINE``: fused chunks
    on device-resident state, warmed), 8 seeded requests of 8 tokens
    arriving 0.05 s apart through HTTP, against the same engine's
    fault-free run; the bench's ``checks`` dict, every entry true."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.serving import RouterConfig, build_server, faults

    cfg, params = params32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),), dtype=np.int32).tolist()
               for n in rng.integers(4, 20, CHAOS_REQ)]
    reqs = [(f"x{i}", p, dict(temperature=0.8, seed=1000 + i)) for i, p in enumerate(prompts)]
    spec = llama.build(cfg)

    def make_engine():
        return ragged.RaggedInferenceEngine(spec, ragged.RaggedConfig(**CHAOS_ENGINE),
                                            dtype=torch.float32, params=params)

    ref_eng = make_engine()  # the fault-free reference first, as the bench
    for uid, p, kw in reqs:
        ref_eng.put(uid, p, max_new_tokens=CHAOS_NEW, **kw)
    ref = ref_eng.generate_all()
    del ref_eng
    eng = make_engine()
    eng.warmup(sampled=True)  # the seeded batches' programs (no top-k)
    telemetry.configure(enabled=True)
    captures0 = eng.programs.captures
    fe, router, loops = build_server([eng], router_cfg=RouterConfig())
    inj = faults.get_fault_injector().configure(CHAOS_SCHEDULE, seed=0)
    try:
        recs = concurrent(lambda r: completion(fe, {"prompt": r[1], "max_tokens": CHAOS_NEW,
                                                    **r[2]}), reqs, stagger_s=0.05)
        _, _, raw = http_json(fe.host, fe.port, "GET", "/healthz")
        healthz = json.loads(raw)
        _, _, page = http_json(fe.host, fe.port, "GET", "/metrics")
        page = page.decode()
    finally:
        fired = inj.counts()
        inj.reset()
        drained = fe.drain(timeout=120)
        telemetry.TELEMETRY.reset()
    leaked = (eng.cfg.num_blocks - 1) - eng.allocator.free_blocks
    completed = [i for i, r in enumerate(recs) if r["status"] == 200]
    mismatches = [i for i in completed if recs[i]["tokens"] != ref[reqs[i][0]]]
    metric_degraded = any(line.split()[-1] not in ("0", "0.0") for line in page.splitlines()
                          if line.startswith(("degraded_mode", "replica_degraded_mode")))
    checks = {
        "no_hung_requests": all(r is not None for r in recs),
        "no_leaked_blocks": leaked == 0,
        "drained_clean": bool(drained),
        "all_responses_terminal": len(recs) == CHAOS_REQ,
        "parity_with_fault_free_run": not mismatches and bool(completed),
        "auto_degraded": eng.degraded_mode >= 1,
        "healthz_degraded": healthz.get("status") == "degraded",
        "metrics_degraded": metric_degraded,
    }
    emit("serving_chaos", model="llama3_8b widths, 2 layers", dtype="float32",
         source="bench.py:2171-2339", schedule=CHAOS_SCHEDULE, checks=checks,
         completed=len(completed), failed=len(recs) - len(completed),
         parity_mismatches=len(mismatches), degraded_mode=eng.degraded_mode,
         degraded_reason=eng.degraded_reason, step_retries=eng.step_retries,
         step_failures=eng.step_failures, loop_crashes=loops[0].crash_count,
         loop_respawns=loops[0].respawn_count, faults_fired=fired,
         captures_on_loop_thread=eng.programs.captures - captures0,
         healthz=healthz.get("status"), nvidia_smi=nvidia_smi("name", "power.limit"))
    if not all(checks.values()):
        raise AssertionError(f"serving_chaos: checks failed: "
                             f"{sorted(k for k, v in checks.items() if not v)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import numpy as np

    # 1. device
    smi = nvidia_smi("name", "power.limit")
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deepspeed_tpu_torch.inference import engine as dense_mod
    from deepspeed_tpu_torch.inference import ragged
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    smem = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = pa.decode_splits(32, HKV, MB, sms)  # at decode_case's 32 tokens
    for name, symbol, args in (("paged_decode", "dstpu_paged_decode_smem_bytes",
                                (HQ, HKV, D, 1, -(-MB // splits))),
                               ("paged_prefill", "dstpu_paged_prefill_smem_bytes", (D, BS, 1)),
                               ("flash_fwd", "dstpu_flash_fwd_smem_bytes", (FD, 1)),
                               ("flash_dkdv", "dstpu_flash_dkdv_smem_bytes", (FD, 1)),
                               ("flash_dq", "dstpu_flash_dq_smem_bytes", (FD, 1))):
        lib = "flash_bwd" if name in ("flash_dkdv", "flash_dq") else name
        fn = getattr(_build.load(lib), symbol)
        fn.restype = ctypes.c_size_t
        smem[name] = fn(*args)
    emit("build", seconds=build_s, nvcc_seconds=dict(_build.BUILD_SECONDS),
         libraries={n: os.path.relpath(p) for n, p in libs.items()},
         ptxas={n: _build.ptxas_report(n) for n in libs},
         dynamic_smem_bytes_at_cell_shapes=smem)

    # 3. kernels vs plain versions, times and bounds; other head dims
    times = kernel_phase(torch, np, pa)
    verify_errs = verify_phase(torch, np, pa)
    times.update(flash_kernel_phase(torch, fa))
    head_dims_phase(torch, np, pa, fa, llama, engine_mod)

    # 4. the serving path, and 5. its parity
    launches, host_run = engine_phase(torch, np, llama, ragged, pa)
    parity_fp32_phase(torch, np, llama, ragged)
    # 5a. the device-resident serving path, and 5b. its parity
    device_launches, eng, device_run = engine_device_phase(torch, np, llama, ragged, pa,
                                                           host_run)
    parity_device_phase(torch, np, llama, ragged, eng)
    del eng
    torch.cuda.empty_cache()
    # 5c. the reference bench's serving configuration: fused chunks
    fused_launches, fused_in_replays, eng, fused_run = engine_fused_phase(
        torch, np, llama, ragged, pa, device_run)
    parity_fused_phase(torch, np, eng)
    # engine_fused's engine, and its weights, serve the serve and steady-decode trials
    fused_eng, weights = eng, eng.params
    del eng
    torch.cuda.empty_cache()
    # 5d. the multi-step scheduler on the bench's configuration, its program
    # check, and 5e. self-speculation on top
    sched_launches, sched_tokens, eng, _ = engine_sched_phase(torch, np, llama, ragged, pa,
                                                              fused_run)
    parity_sched_phase(torch, np, eng)
    del eng
    torch.cuda.empty_cache()
    spec_launches, _, eng, _ = engine_sched_phase(torch, np, llama, ragged, pa, fused_run,
                                                  sched_run=sched_tokens)
    del eng
    torch.cuda.empty_cache()
    # 5f. seeded sampling: exact threefry bits and the sampler's distribution
    sampling_phase(torch, np)
    # 5g. bench.py's serve trial (ragged vs dense vs naive, staggered) and
    # 5h. its steady-decode trial, on engine_fused's weights; their fp32
    # checks on 2 layers at full width
    cfg2 = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    params32 = (cfg2, llama.init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                                        torch.float32, "cuda"))
    serve_trial_phase(torch, np, llama, dense_mod, fused_eng, params32)
    # 5g'. the HTTP serving tier: engine_fused's engine behind the frontend
    # under bench.py's open-loop client, then its fp32 parity, disaggregated
    # cluster and chaos checks on 2 layers at full width
    serving_launches = serving_phase(torch, np, pa, fused_eng)
    parity_eng, _ = serving_parity_phase(torch, np, llama, ragged, params32)
    decode_eng = serving_cluster_phase(torch, np, llama, ragged, params32, parity_eng)
    del parity_eng, decode_eng
    serving_chaos_phase(torch, np, llama, ragged, params32)
    del fused_eng
    gc.collect()
    torch.cuda.empty_cache()
    steady_launches = decode_steady_phase(torch, np, llama, ragged, dense_mod, pa, weights,
                                          params32)
    # 5i. the prefix cache, 5j. KV tiers and 5k. KV handoff on the same weights
    prefix_launches = prefix_cache_phase(torch, np, llama, ragged, pa, weights, params32)
    tier_launches = kv_tier_phase(torch, np, llama, ragged, pa, weights, params32)
    handoff_launches = handoff_phase(torch, np, llama, ragged, pa, weights, params32,
                                     fused_run["tokens"])
    # 5l. low-bit KV pools and 5m. weight-only quantization on the same weights
    kvq_launches, _ = kv_quant_phase(torch, np, llama, ragged, pa, weights, params32, fused_run)
    woq_launches = woq_phase(torch, np, llama, ragged, dense_mod, pa, weights, fused_run)
    del weights, params32
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the training path, and 7. its parity
    launches.update(train_phase(torch, np, llama, engine_mod, fa))
    train_parity_phase(torch, np, llama, engine_mod)
    # 7a. forward / backward / step against train_batch, 7b. the hybrid
    # engine, 7c. bench.py's learn trial with the sentinel on and off
    fbs_launches = train_fbs_phase(torch, np, llama, engine_mod, fa)
    hybrid_phase(torch, np, llama, dense_mod)
    learn_launches = learn_phase(torch, np, llama, engine_mod, fa)
    # 8. ZeRO stages 1-3 against stage 0, and 9. checkpoints, both under NCCL;
    # the kill-and-resume legs (12) run beside 9-11 in processes of their own,
    # or after 11 with --train-chaos-after (9-11's seconds then the card's alone)
    zero_launches = train_zero_phase(torch, np, llama, engine_mod, fa)
    legs = None if "--train-chaos-after" in sys.argv[1:] else train_chaos_start()
    try:
        ckpt_launches, save_dir, _ = checkpoint_phase(torch, np, llama, engine_mod, fa)
        try:
            # 10. self-healing on the checkpoint's tag, 11. serving from it
            sentinel_launches = sentinel_phase(torch, np, llama, engine_mod, fa, save_dir)
            serve_from_checkpoint_phase(torch, np, llama, dense_mod, save_dir)
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
    finally:
        if legs is not None:
            train_chaos_finish(*legs)
    if legs is None:
        train_chaos_finish(*train_chaos_start())

    csrc = "deepspeed_tpu_torch/ops/cuda/csrc/"
    sources = {"paged_decode": (csrc + "paged_decode.cu",
                                "deepspeed_tpu/ops/pallas/paged_attention.py:37"),
               "paged_prefill": (csrc + "paged_prefill.cu",
                                 "deepspeed_tpu/ops/pallas/paged_attention.py:135"),
               "flash_fwd": (csrc + "flash_fwd.cu",
                             "deepspeed_tpu/ops/pallas/flash_attention.py:40"),
               "flash_dkdv": (csrc + "flash_bwd.cu",
                              "deepspeed_tpu/ops/pallas/flash_attention.py:170"),
               "flash_dq": (csrc + "flash_bwd.cu",
                            "deepspeed_tpu/ops/pallas/flash_attention.py:216")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name],
                            launches_per=("engine run" if name.startswith("paged")
                                          else "training step"),
                            launches_engine_device=device_launches.get(name),
                            launches_engine_fused=fused_launches.get(name),
                            launches_engine_fused_in_replays=fused_in_replays.get(name),
                            launches_engine_sched=sched_launches.get(name),
                            launches_engine_spec=spec_launches.get(name),
                            launches_decode_steady_sched=steady_launches.get(name),
                            launches_prefix_cache=prefix_launches.get(name),
                            launches_kv_tier=tier_launches.get(name),
                            launches_handoff=handoff_launches.get(name),
                            launches_kv_quant_int8=kvq_launches.get(name),
                            launches_woq=woq_launches.get(name),
                            launches_serving=serving_launches.get(name),
                            launches_train_zero_per_step={
                                str(stage): c.get(name) for stage, c in zero_launches.items()},
                            launches_checkpoint=ckpt_launches.get(name),
                            launches_train_fbs=fbs_launches.get(name),
                            launches_learn=learn_launches.get(name),
                            launches_sentinel=sentinel_launches.get(name),
                            max_abs_err=t["max_abs_err"],
                            max_abs_err_fp32=t["max_abs_err_fp32"],
                            **({"max_abs_err_verify_batch": verify_errs}
                               if name == "paged_decode" else {}),
                            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
