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
   at the 8B serving shapes, and each flash-attention kernel (forward,
   dK/dV, dQ) at the training shapes (B=2, S=4096, Hq=32, Hkv=8, D=128,
   causal), in bf16 and fp32; then timed beside its bound, its plain
   version and a library yardstick (SDPA, which the port never calls; the
   backward kernels' ``kernel_time`` lines add an estimate, not a
   measurement, of their part of SDPA's one backward call: its time times
   their share of the pair's flops);
4. engine: 32 requests x 48 greedy tokens through ``put()`` and
   ``generate_all()``, run twice on one engine, the second run reported,
   with the kernels' launch counts taken over that run alone; then a third
   run under ``torch.profiler`` for device time by kernel class;
5. parity: a mixed decode + prefill-tile step replayed through the kernels
   and through the plain attention path (bf16, 32 layers), and the same in
   fp32 on a 2-layer full-width model together with greedy tokens of a short
   run through both paths;
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
def decode_case(torch, np, dtype):
    """T = 32 tokens: 28 sequences with contexts 1..560 on and around block
    edges, each in its own slot with blocks drawn from a permutation of the
    pool, plus 4 padding tokens (slot max_seqs, position 0)."""
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
    kp = torch.tensor(rng.normal(size=(NB, BS, HKV, D)), dtype=dtype, device="cuda")
    vp = torch.tensor(rng.normal(size=(NB, BS, HKV, D)), dtype=dtype, device="cuda")
    q = torch.tensor(rng.normal(size=(len(pos), HQ, D)), dtype=dtype, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q, kp, vp, torch.tensor(slots, **i32), torch.tensor(pos, **i32),
            torch.tensor(bt, **i32))


def prefill_case(torch, np, dtype):
    """8 tiles of CT = 128 as the engine lays out a 1024-token step: a 512-
    token prompt (4 tiles), a 228-token prompt (pad rows), a 64-token prompt
    (pad rows) and one all-pad tile."""
    rng = np.random.default_rng(1)
    ct, max_seqs = 128, 32
    tiles = [(0, 0, 128), (0, 128, 128), (0, 256, 128), (0, 384, 128),
             (1, 0, 128), (1, 128, 100), (2, 0, 64), (max_seqs, 0, 0)]
    bt = np.zeros((max_seqs + 1, MB), np.int32)
    perm = iter(rng.permutation(np.arange(1, NB)))
    for s, length in ((0, 512), (1, 228), (2, 64)):
        for j in range(-(-length // BS)):
            bt[s, j] = next(perm)
    kp = torch.tensor(rng.normal(size=(NB, BS, HKV, D)), dtype=dtype, device="cuda")
    vp = torch.tensor(rng.normal(size=(NB, BS, HKV, D)), dtype=dtype, device="cuda")
    q = torch.tensor(rng.normal(size=(len(tiles) * ct, HQ, D)), dtype=dtype, device="cuda")
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


def prefill_check(torch, np, pa) -> dict:
    """The bf16 tensor-core prefill kernel against its plain version at
    ``prefill_case``: relative Frobenius error within FLASH_BF16_REL_FRO,
    beside the control (the plain version with the softmax scale one bf16
    ulp too large), which must lie beyond it; pad rows and the all-pad tile
    exact zeros."""
    args, ct = prefill_case(torch, np, torch.bfloat16)
    got = pa.ragged_prefill_attention(*args, ct)
    want = pa.ragged_prefill_attention_ref(*args, ct)
    control = pa.ragged_prefill_attention_ref(*args, ct, scale=FLASH_CONTROL_SCALE / D ** 0.5)
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
    for name, make, kernel, ref, work, lib in (
            ("paged_decode", lambda dt: (decode_case(torch, np, dt), None),
             pa.paged_decode_attention, pa.paged_decode_attention_ref,
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
        emit("kernel_time", kernel=name, dtype="bfloat16", bytes=nbytes, flops=flops,
             share_of_bound=bound_ms / ms, **results[name])
        del args
    del flush
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------- flash kernels
def flash_inputs(torch, dtype, seed=0):
    """q, k, v, dO of the training cell's attention, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(h):
        return torch.randn((FB, FS, h, FD), generator=g, device="cuda").to(dtype)

    return draw(HQ), draw(HKV), draw(HKV), draw(HQ)


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


def flash_check(torch, fa, dtype) -> dict:
    """Each flash kernel against its plain version on the same inputs at the
    training cell's shapes; the backward kernels get the plain forward's o
    and lse, so only they differ. Per kernel: max abs error and whether it
    passes. fp32: |got - want| <= 1e-4 (1 + |want|) for every output. bf16:
    lse (fp32 in both) within FLASH_LSE_ATOL, and o, dq, dk, dv each within
    FLASH_BF16_REL_FRO relative Frobenius error; beside it the control: the
    plain version with the softmax scale one bf16 ulp too large, which
    must lie beyond the limit, so the limit is shown to tell such a fault
    from rounding."""
    q, k, v, do = flash_inputs(torch, dtype)
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
        scale = FLASH_CONTROL_SCALE / FD ** 0.5
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
            emit("kernel_check", kernel=name, dtype=dname, shape=[FB, FS, HQ, HKV, FD],
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
        emit("kernel_time", kernel=name, dtype="bfloat16", shape=[FB, FS, HQ, HKV, FD],
             bytes=nbytes, flops=flops, share_of_bound=bound_ms / times[name],
             achieved_tflops=flops / times[name] / 1e9,
             library="SDPA forward" if name == "flash_fwd" else
             "SDPA backward (dq, dk, dv together)", **results[name], **estimate)
    del q, k, v, do, o, lse, delta, sq, sk, sv, sdo, so, flush
    torch.cuda.empty_cache()
    return results


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
                cache={k: v.clone() for k, v in cache.items()})
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
    rcfg = ragged.RaggedConfig(**ENGINE)
    t0 = time.perf_counter()
    eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [eng.params["embed"], eng.params["final_norm"], eng.params["lm_head"],
                       *eng.params["layers"].values()])
    pool_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
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
    emit("engine_run", requests=len(out), new_tokens_each=MAX_NEW, generated_tokens=gen,
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
    return launches


def parity_fp32_phase(torch, np, llama, ragged):
    """2 of Llama-3-8B's 32 layers at full width, fp32: logits of a mixed
    step through the kernels vs the plain path (atol 1e-3), and greedy tokens
    of 8 short requests through each path."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    rcfg = ragged.RaggedConfig(**ENGINE)
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
    for name, symbol, args in (("paged_decode", "dstpu_paged_decode_smem_bytes", (HQ, HKV, D, BS)),
                               ("paged_prefill", "dstpu_paged_prefill_smem_bytes", (D, BS, 1)),
                               ("flash_fwd", "dstpu_flash_fwd_smem_bytes", (FD, 1)),
                               ("flash_dkdv", "dstpu_flash_dkdv_smem_bytes", (FD, 1)),
                               ("flash_dq", "dstpu_flash_dq_smem_bytes", (FD, 1))):
        lib = "flash_bwd" if name in ("flash_dkdv", "flash_dq") else name
        fn = getattr(_build.load(lib), symbol)
        fn.restype = ctypes.c_size_t
        smem[name] = fn(*args)
    emit("build", seconds=build_s,
         libraries={n: os.path.relpath(p) for n, p in libs.items()},
         ptxas={n: _build.ptxas_report(n) for n in libs},
         dynamic_smem_bytes_at_cell_shapes=smem)

    # 3. kernels vs plain versions, times and bounds
    times = kernel_phase(torch, np, pa)
    times.update(flash_kernel_phase(torch, fa))

    # 4. the serving path, and 5. its parity
    launches = engine_phase(torch, np, llama, ragged, pa)
    parity_fp32_phase(torch, np, llama, ragged)

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
                            max_abs_err=t["max_abs_err"],
                            max_abs_err_fp32=t["max_abs_err_fp32"],
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
