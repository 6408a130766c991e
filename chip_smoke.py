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
   in a global workspace; at 2048 also timed, for information), and a few
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
   launches counted per replay), then a profiled run;
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
6. train: ``initialize`` with the config of ``bench.py:trial_main``, 2
   warm-up and 8 timed steps on fresh ``default_rng(0)`` batches with the
   flash kernels' launch counts per step, tokens/s, MFU and peak memory;
   one step under ``torch.profiler``; then 8 steps on one repeated batch,
   whose loss must fall;
7. train parity: loss, every gradient and a 4-step loss trajectory through
   the kernels vs through the plain attention path in fp32 (2 layers,
   full width, B=1, S=2048), and the gradients' relative error in bf16 at
   4 layers.

Each phase prints one JSON line. The script ends with a ``{"kernels": ...}``
line and, as its last line, ``{"ok": true, "device": {...}}``; any failure
exits nonzero without that line. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial

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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
def decode_case(torch, np, dtype, d=D):
    """T = 32 tokens: 28 sequences with contexts 1..560 on and around block
    edges, each in its own slot with blocks drawn from a permutation of the
    pool, plus 4 padding tokens (slot max_seqs, position 0); head dim d."""
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
    kp = torch.tensor(rng.normal(size=(NB, BS, HKV, d)), dtype=dtype, device="cuda")
    vp = torch.tensor(rng.normal(size=(NB, BS, HKV, d)), dtype=dtype, device="cuda")
    q = torch.tensor(rng.normal(size=(len(pos), HQ, d)), dtype=dtype, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q, kp, vp, torch.tensor(slots, **i32), torch.tensor(pos, **i32),
            torch.tensor(bt, **i32))


def prefill_case(torch, np, dtype, d=D):
    """8 tiles of CT = 128 as the engine lays out a 1024-token step: a 512-
    token prompt (4 tiles), a 228-token prompt (pad rows), a 64-token prompt
    (pad rows) and one all-pad tile; head dim d."""
    rng = np.random.default_rng(1)
    ct, max_seqs = 128, 32
    tiles = [(0, 0, 128), (0, 128, 128), (0, 256, 128), (0, 384, 128),
             (1, 0, 128), (1, 128, 100), (2, 0, 64), (max_seqs, 0, 0)]
    bt = np.zeros((max_seqs + 1, MB), np.int32)
    perm = iter(rng.permutation(np.arange(1, NB)))
    for s, length in ((0, 512), (1, 228), (2, 64)):
        for j in range(-(-length // BS)):
            bt[s, j] = next(perm)
    kp = torch.tensor(rng.normal(size=(NB, BS, HKV, d)), dtype=dtype, device="cuda")
    vp = torch.tensor(rng.normal(size=(NB, BS, HKV, d)), dtype=dtype, device="cuda")
    q = torch.tensor(rng.normal(size=(len(tiles) * ct, HQ, d)), dtype=dtype, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    meta = [torch.tensor(c, **i32) for c in zip(*tiles)]
    return (q, kp, vp, *meta, torch.tensor(bt, **i32)), ct


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


def profile_phase(torch, work, phase="profile"):
    """``work()`` under torch.profiler: device time by kernel class and the
    device's busy share of the wall time (the profiler's own host overhead
    lengthens that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class: dict[str, float] = {}
    for e in kernels:
        c = kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by_class.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit(phase, wall_ms=wall * 1e3, device_busy_ms=busy,
         device_busy_share=busy / (wall * 1e3), device_ms_by_class=by_class,
         top_kernels=[{"name": e.key[:90], "count": e.count,
                       "device_ms": e.self_device_time_total / 1e3} for e in top])


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
    launches = {"paged_decode": pa.paged_decode_attention.launches,
                "paged_prefill": pa.ragged_prefill_attention.launches}
    plain_calls = (pa.paged_decode_attention_ref.calls
                   + pa.ragged_prefill_attention_ref.calls)
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
    launches = {"paged_decode": pa.paged_decode_attention.launches,
                "paged_prefill": pa.ragged_prefill_attention.launches}
    plain_calls = (pa.paged_decode_attention_ref.calls
                   + pa.ragged_prefill_attention_ref.calls)
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
    profile_phase(torch, lambda: run(eng, prompts, MAX_NEW), phase="profile_device")
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
                                           forwards=d["forwards"])


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

    fn = eng._get_dev_fused(t, k, nd, nt, mb, staged)
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

    fn = eng._get_dev_sched(k, t, mb, staged)
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
    key = ("sched", k, t, mb, 0)
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

    # 6. the training path, and 7. its parity
    launches.update(train_phase(torch, np, llama, engine_mod, fa))
    train_parity_phase(torch, np, llama, engine_mod)

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
