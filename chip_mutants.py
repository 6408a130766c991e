#!/usr/bin/env python3
"""How far apart chip_smoke.py's checks put a correct kernel and a broken
one, on one CUDA card.

Each mutant is one kernel source with one edit. The script copies the
checkout's sources into a temporary directory, applies the edit there (the
repository's sources are not touched), builds the kernels that include the
edited file from the copy with the same nvcc flags, and swaps them in for
the real ones. For the correct kernels and each mutant it prints one JSON
line with the readings of chip_smoke.py's checks of the mutant's path.

Serving mutants (``paged_common.cuh``: the decode kernel and the fp32
prefill kernel; ``paged_prefill.cu``: the bf16 tensor-core prefill kernel):
- ``kernel_bf16``: max abs error of each paged kernel against its plain
  version at the 8B shapes of chip_smoke.py, bf16 (decode limit 2e-2 (1 +
  |want|)), and the prefill kernel's relative Frobenius error and pad-row
  check (limit 5e-3; the control, a softmax scale one bf16 ulp large, reads
  beside it);
- ``replay_bf16``: the captured mixed step of Llama-3-8B (32 layers, random
  bf16 weights) through the kernels vs the plain path: relative Frobenius
  error of the logits (limit 5e-2) and top-1 agreement;
- ``replay_fp32``: the same on the 2-layer full-width model in fp32: max abs
  error (limit 1e-3), and whether greedy tokens of 8 short requests equal
  those through the plain path.

Training mutants (``flash_fwd.cu``, ``flash_bwd.cu``; the ``_mma_`` and
``_wgmma_`` ones edit code only the bf16 tensor-core kernels run):
- ``flash_bf16``: each flash kernel against its plain version at the
  training cell's shapes, bf16: the relative Frobenius error of o, dq, dk
  and dv (limit 5e-3), the max abs error of lse (limit 1e-4) and whether
  the kernel passes;
- ``train_parity``: chip_smoke.py's train parity readings: fp32 at 2 layers
  (loss abs error, limit 1e-3; largest per-leaf relative Frobenius error of
  the gradients, limit 1e-3; 4-step trajectory abs error, limit 1e-3) and
  bf16 at 4 layers (gradients, limit 5e-2).

Run from the repository root:

    python3 chip_mutants.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import traceback
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import chip_smoke as smoke

# name -> (source file, its text, the replacement)
MUTANTS = {
    # a key is visible only strictly before the query: drops the diagonal
    "mask_off_by_one": ("paged_common.cuh", "kpos0 + kk <= qpos[i]", "kpos0 + kk < qpos[i]"),
    # the softmax scale one bf16 ulp (2^-7) too large
    "scale_one_bf16_ulp": ("paged_common.cuh", "* scale : 0.f",
                           "* (scale * 1.0078125f) : 0.f"),
    # probabilities rounded to bf16 before P @ V
    "probs_rounded_to_bf16": ("paged_common.cuh", "pw[i * bs + kk] = e;",
                              "pw[i * bs + kk] = __bfloat162float(__float2bfloat16(e));"),
    # the flash forward's causal mask off by one: the diagonal is hidden too
    "flash_fwd_mask_off_by_one": ("flash_fwd.cu", "(causal && kpos > qpos)",
                                  "(causal && kpos >= qpos)"),
    # delta = rowsum(dO * O) dropped from ds in the dQ kernel
    "flash_dq_delta_dropped": ("flash_bwd.cu", "return p * (dp - delta) * scale;",
                               "return p * dp * scale;"),
    # tensor-core (bf16) kernels only: the forward's softmax scale one bf16
    # ulp too large
    "flash_fwd_mma_scale_one_bf16_ulp": (
        "flash_fwd.cu", "const float scale_log2 = scale * kLog2e;  // scores to log2 units",
        "const float scale_log2 = (scale * 1.0078125f) * kLog2e;"),
    # the bf16 forward's ring stops one key tile short: producer and
    # consumers skip each CTA's last visible k / v tile
    "flash_fwd_wgmma_skips_last_kv_tile": (
        "flash_fwd.cu",
        "const int n_kt = dstpu::flash::key_tiles(q0, kRows, n_q, n_kv, causal, kKeys);",
        "const int n_kt = dstpu::flash::key_tiles(q0, kRows, n_q, n_kv, causal, kKeys) - 1;"),
    # the bf16 dQ kernel's producer loads k from the next kv head, not the
    # one of the q-head's GQA group (v stays right)
    "flash_dq_wgmma_wrong_kv_head": (
        "flash_bwd.cu",
        "hw::tma_load_tiles(ring.stage(n), &tm_k, bar, NP, 1, n * kDqKeys, kvh, b);",
        "hw::tma_load_tiles(ring.stage(n), &tm_k, bar, NP, 1, n * kDqKeys, (kvh + 1) % hkv, b);"),
    # tensor-core (bf16) kernels only: the dK/dV kernel's ds one bf16 ulp too
    # large, so dK is 2^-7 too large
    "flash_dkdv_mma_ds_one_bf16_ulp": (
        "flash_bwd.cu", "return st[i] * (dpt[i] - rows[kQ + qr]) * scale;",
        "return st[i] * (dpt[i] - rows[kQ + qr]) * (scale * 1.0078125f);"),
    # the bf16 dK/dV kernel's ring carries one q-head of each GQA group too
    # few: producer and consumers skip the group's last q-head
    "flash_dkdv_wgmma_drops_last_q_head": (
        "flash_bwd.cu", "const int total = rep * per_head;",
        "const int total = (rep - 1) * per_head;"),
    # the bf16 tensor-core prefill's causal mask off by one: the diagonal
    # is hidden
    "prefill_tc_mask_off_by_one": ("paged_prefill.cu", "kpos <= qpos[e >> 1]",
                                   "kpos < qpos[e >> 1]"),
    # the bf16 tensor-core prefill's softmax scale one bf16 ulp too large
    "prefill_tc_scale_one_bf16_ulp": (
        "paged_prefill.cu", "const float scale_log2 = scale * 1.4426950408889634f;",
        "const float scale_log2 = (scale * 1.0078125f) * 1.4426950408889634f;"),
}
# the kernels each source is compiled into
BUILT_FROM = {"paged_common.cuh": ("paged_decode", "paged_prefill"),
              "paged_prefill.cu": ("paged_prefill",),
              "flash_fwd.cu": ("flash_fwd",), "flash_bwd.cu": ("flash_bwd",)}
SERVING = [m for m, (src, _, _) in MUTANTS.items()
           if src in ("paged_common.cuh", "paged_prefill.cu")]
TRAINING = [m for m in MUTANTS if m not in SERVING]


def mutant_sources(build, tag: str, src: str, old: str, new: str) -> Path:
    out = Path(tempfile.mkdtemp(prefix=f"dstpu-mutant-{tag}-"))
    for f in build.CSRC.glob("*.cu*"):
        shutil.copy(f, out / f.name)
    path = out / src
    text = path.read_text()
    if text.count(old) != 1:
        raise AssertionError(f"mutant {tag}: {old!r} is not once in {src}")
    path.write_text(text.replace(old, new))
    return out


def nvcc(build, srcdir: Path, name: str) -> Path:
    lib = srcdir / f"{name}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(srcdir / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise build.KernelBuildError(f"nvcc failed for {srcdir.name}/{name}:\n{proc.stderr}")
    return lib


def build_variants(build) -> tuple[dict[str, dict[str, ctypes.CDLL]], list[Path]]:
    """Every variant's libraries, built at once (one nvcc per source): the
    correct kernels, and for each mutant the kernels its edited file is
    compiled into, over the correct ones."""
    dirs = {tag: mutant_sources(build, tag, *edit) for tag, edit in MUTANTS.items()}
    with ThreadPoolExecutor(max_workers=2 * len(dirs) + len(build.KERNELS)) as ex:
        jobs = {("correct", n): ex.submit(build.build, n) for n in build.KERNELS}
        jobs.update({(tag, n): ex.submit(nvcc, build, d, n)
                     for tag, d in dirs.items() for n in BUILT_FROM[MUTANTS[tag][0]]})
        paths = {key: f.result() for key, f in jobs.items()}
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for (tag, name), path in paths.items():
        libs.setdefault(tag, {})[name] = ctypes.CDLL(str(path))
    for tag in MUTANTS:
        libs[tag] = {**libs["correct"], **libs[tag]}
    return libs, list(dirs.values())


def use(build, libs: dict[str, ctypes.CDLL]) -> None:
    """Make the kernel wrappers launch ``libs`` from now on."""
    with build._LOCK:
        build._LIBS.update(libs)


def kernel_errors(torch, np, pa) -> dict:
    dec = smoke.decode_case(torch, np, torch.bfloat16)
    got, want = pa.paged_decode_attention(*dec), pa.paged_decode_attention_ref(*dec)
    pre = smoke.prefill_check(torch, np, pa)
    return {"paged_decode": (got.float() - want.float()).abs().max().item(),
            "paged_prefill": {k: pre[k] for k in ("max_abs_err", "rel_fro", "control_rel_fro",
                                                  "pad_rows_zero", "ok")}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import numpy as np

    from deepspeed_tpu_torch.inference import ragged
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    print(smoke.nvidia_smi("name", "power.limit"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs, tmpdirs = build_variants(_build)
    try:
        rows = {tag: {"variant": tag} for tag in libs}
        serving, training = ["correct", *SERVING], ["correct", *TRAINING]
        for tag in serving:
            use(_build, libs[tag])
            rows[tag]["kernel_bf16"] = kernel_errors(torch, np, pa)

        # bf16, 32 layers: capture a mixed step with the correct kernels
        cfg = llama.LlamaConfig.llama3_8b()
        rcfg = ragged.RaggedConfig(**smoke.ENGINE)
        use(_build, libs["correct"])
        eng = ragged.RaggedInferenceEngine(llama.build(cfg), rcfg, dtype=torch.bfloat16,
                                           seed=0)
        cap = smoke.StepCapture(eng)
        smoke.run(eng, smoke.requests(np, cfg.vocab_size), smoke.MAX_NEW)
        cap.restore()
        if cap.saved is None:
            raise AssertionError("no step mixed decodes with prefill tiles")
        for tag in serving:
            use(_build, libs[tag])
            res = smoke.replay(torch, llama, cfg, eng.params, cap.saved, rcfg.max_seqs)
            rows[tag]["replay_bf16"] = {k: res[k] for k in ("rel_frobenius_err",
                                                            "top1_agreement")}
        del eng, cap
        torch.cuda.empty_cache()

        # fp32, 2 layers at full width
        cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                                   torch.float32, "cuda")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
                   for n in (40, 64, 100, 33, 150, 7, 80, 129)]

        def engine(impl):
            spec = dataclasses.replace(
                llama.build(cfg),
                ragged_forward_fn=partial(llama.ragged_forward, cfg, attn_impl=impl))
            return ragged.RaggedInferenceEngine(spec, rcfg, dtype=torch.float32,
                                                params=params)

        plain_tokens = smoke.run(engine("plain"), prompts, 8)
        use(_build, libs["correct"])
        eng = engine("auto")
        cap = smoke.StepCapture(eng)
        smoke.run(eng, prompts, 8)
        saved = cap.saved
        del eng, cap
        if saved is None:
            raise AssertionError("no step mixed decodes with prefill tiles")
        for tag in serving:
            use(_build, libs[tag])
            res = smoke.replay(torch, llama, cfg, params, saved, rcfg.max_seqs)
            tokens = smoke.run(engine("auto"), prompts, 8)
            rows[tag]["replay_fp32"] = {"max_abs_err": res["max_abs_err"],
                                        "greedy_tokens_identical": tokens == plain_tokens}
        del params
        torch.cuda.empty_cache()

        # training: the flash kernels at the cell's shapes, then train parity
        for tag in training:
            use(_build, libs[tag])
            rows[tag]["flash_bf16"] = {
                name: {k: r[k] for k in ("rel_fro", "lse_abs_err", "ok") if k in r}
                for name, r in smoke.flash_check(torch, fa, torch.bfloat16).items()}
            parity = smoke.train_parity(torch, np, llama, engine_mod)
            rows[tag]["train_parity"] = {
                "fp32": {k: parity["fp32"][k] for k in ("loss_abs_err", "max_rel_frobenius_err",
                                                        "trajectory_max_abs_err")},
                "bf16": {"max_rel_frobenius_err": parity["bf16"]["max_rel_frobenius_err"]}}
        for row in rows.values():
            print(json.dumps(row), flush=True)
    finally:
        for d in tmpdirs:
            shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 - any failure fails the run
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
