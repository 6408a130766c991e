#!/usr/bin/env python3
"""How far apart chip_smoke.py's checks put a correct kernel and a broken
one, on one CUDA card.

Each mutant is one kernel source with one edit. The script copies the
checkout's sources into a temporary directory, applies the edit there (the
repository's sources are not touched), builds the kernels that include the
edited file from the copy with the same nvcc flags, and swaps them in for
the real ones. For the correct kernels and each mutant it prints one JSON
line with the readings of chip_smoke.py's checks of the mutant's path.

Serving mutants (``paged_decode.cu``: the split-context decode kernel;
``paged_prefill.cu``: the bf16 tensor-core prefill kernel):
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

Device-path mutants (``inference/ragged.py``, the device-resident engine
and the fused chunks; the edited module is loaded under a name of its own,
the package's is not touched):
- ``parity_device_fp32``: chip_smoke.py's parity_device readings: whether
  greedy tokens of the device-resident engine, without and with run-ahead
  48, and of the fused engine on the device and host-staged paths, equal
  the host-staged engine's (8 requests x 48 tokens, 2 layers at full width,
  fp32), and how many graphs each replayed;
- ``fused_program_fp32``: chip_smoke.py's fused program check on a fused
  engine of that 2-layer fp32 model: replay vs eager bit-identical, and KV
  rows written outside the rows and steps the program schedules (limit 0);
- ``parity_sched_fp32``: whether the scheduler engines' greedy tokens (the
  device and fused paths with ``sched_steps`` 16, without and with
  ``spec_draft`` 4) equal the host-staged engine's, same run;
- ``sched_program_fp32``: chip_smoke.py's scheduler program check on a
  scheduler engine of that model: replay vs eager bit-identical, steps as
  the probe predicts, iterations against the deepest row's steps (must be
  equal), KV rows outside the positions fed (limit 0), and the iterations
  of the full (16), early-exit (at most 3) and all-retired (0) replays.
  The speculation mutant edits ``inference/sampling.py``; the engine module
  is then loaded anew with its imported names bound to the edited ones.

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
import types
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import chip_smoke as smoke

# name -> (source file, its text, the replacement)
MUTANTS = {
    # decode: a key is visible only strictly before the query: drops the
    # diagonal
    "mask_off_by_one": ("paged_decode.cu", "kpos <= pos && kpos < split_end",
                        "kpos < pos && kpos < split_end"),
    # decode: the softmax scale one bf16 ulp (2^-7) too large
    "scale_one_bf16_ulp": ("paged_decode.cu", "* scale : 0.f",
                           "* (scale * 1.0078125f) : 0.f"),
    # decode: probabilities rounded to bf16 before P @ V
    "probs_rounded_to_bf16": ("paged_decode.cu", "pr[i] = seen ? expf(x - m_new) : 0.f;",
                              "pr[i] = seen ? __bfloat162float(__float2bfloat16("
                              "expf(x - m_new))) : 0.f;"),
    # decode: the merge leaves out the last live split of each context
    "decode_drops_last_split": ("paged_decode.cu",
                                "u < n_live; ++u) {\n      const float w",
                                "u < n_live - 1; ++u) {\n      const float w"),
    # decode: the merge adds the splits' partials without the exp(m_s - m)
    # factor that puts them on one scale
    "decode_combine_skips_rescale": ("paged_decode.cu",
                                     "const float w = expf(__ldcg(mlr + 2 * u) - mx);",
                                     "const float w = 1.f;"),
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
# name -> (module of the port, its text, the replacement): the device path
PY_MUTANTS = {
    # the readback reads a graph's static output, which the next replay of
    # that graph has overwritten by the time the dispatch is reconciled
    "graph_output_not_copied": ("deepspeed_tpu_torch.inference.ragged",
                                "        host.copy_(out, non_blocking=True)\n",
                                "        host = out\n"),
    # a run-ahead chunk leaves each slot's position row where it was
    "pos_row_not_advanced": ("deepspeed_tpu_torch.inference.ragged",
                             "            pos_st.index_add_(0, sl, torch.where(real, k, 0)"
                             ".to(torch.int32))\n", ""),
    # a fused chunk's decode rows feed the staged host token (0: the host
    # does not have the previous chunk's picks yet), not their slot row's
    "fused_feed_ignores_device_token": ("deepspeed_tpu_torch.inference.ragged",
                                        "torch.where(feed, tok_st[sl], staged[0:t])",
                                        "staged[0:t]"),
    # a frozen or retired row of a fused scan keeps its real slot (at
    # position 0): it writes KV into its own sequence's first block
    "fused_frozen_row_writes_state": ("deepspeed_tpu_torch.inference.ragged",
                                      "s = torch.where(active, dec_slots, max_seqs)",
                                      "s = dec_slots"),
    # no copy of a fused chunk's output behind its dispatch: with three
    # chunks in flight a later replay of the same graph has overwritten it
    # by the time the chunk is reconciled
    "fused_output_not_copied": ("deepspeed_tpu_torch.inference.ragged",
                                '"out": self._readback(packed)', '"out": (packed, None)'),
    # a scheduler row that retired (EOS or budget) keeps its lanes on its
    # own slot: it writes KV past the tokens it surfaced
    "sched_retired_row_not_masked": (
        "deepspeed_tpu_torch.inference.ragged",
        "speculative_lane_layout(toks, draft, pos, live, cap, slots,",
        "speculative_lane_layout(toks, draft, pos, real, cap, slots,"),
    # the loop's predicate is taken before the iteration's retirements
    # update ``done``: the exit is off by one iteration (the loop runs one
    # past the iteration where its last row retired)
    "sched_exit_one_iteration_early": (
        "deepspeed_tpu_torch.inference.ragged",
        "            done.copy_(done | ((eos >= 0) & (last == eos) & (n_emit > 0)) | (emitted >= bud))\n"
        "            counts[:2].add_(torch.stack([torch.where(live, d, 0).sum(), n_acc.sum()])\n"
        "                            .to(torch.int32))\n"
        "            counts[2:].add_(1)\n"
        "            pred.copy_((~done).any())\n",
        "            pred.copy_((~done).any())\n"
        "            done.copy_(done | ((eos >= 0) & (last == eos) & (n_emit > 0)) | (emitted >= bud))\n"
        "            counts[:2].add_(torch.stack([torch.where(live, d, 0).sum(), n_acc.sum()])\n"
        "                            .to(torch.int32))\n"
        "            counts[2:].add_(1)\n"),
    # acceptance counts the first mismatching draft lane as accepted
    "spec_accepts_one_past_mismatch": (
        "deepspeed_tpu_torch.inference.sampling",
        "a = torch.where(draft != picked[:, :d], lane_i[:, :d], d).amin(dim=1) if d else",
        "a = torch.clamp(torch.where(draft != picked[:, :d], lane_i[:, :d], d).amin(dim=1) + 1,"
        " max=d) if d else"),
}
RAGGED = "deepspeed_tpu_torch.inference.ragged"
# the kernels each source is compiled into
BUILT_FROM = {"paged_decode.cu": ("paged_decode",),
              "paged_prefill.cu": ("paged_prefill",),
              "flash_fwd.cu": ("flash_fwd",), "flash_bwd.cu": ("flash_bwd",)}
SERVING = [m for m, (src, _, _) in MUTANTS.items()
           if src in ("paged_decode.cu", "paged_prefill.cu")]
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


def _load_edited(name: str, tag: str, old: str = "", new: str = ""):
    """Module ``name`` with ``old`` replaced by ``new`` (once), loaded under a
    name of its own (the real module stays as it is)."""
    import importlib

    real = importlib.import_module(name)
    text = Path(real.__file__).read_text()
    if old and text.count(old) != 1:
        raise AssertionError(f"mutant {tag}: {old!r} is not once in {name}")
    mod = types.ModuleType(f"{name}_mutant_{tag}")
    mod.__file__ = real.__file__
    sys.modules[mod.__name__] = mod  # dataclasses look their module up
    exec(compile(text.replace(old, new) if old else text, f"{real.__file__} ({tag})", "exec"),
         mod.__dict__)
    return mod, real


def mutant_module(tag: str):
    """The ragged engine module with ``PY_MUTANTS[tag]``'s edit: the edited
    module itself, or a copy of the engine module whose names imported from
    the edited module are the edited ones."""
    name, old, new = PY_MUTANTS[tag]
    mod, real = _load_edited(name, tag, old, new)
    if name == RAGGED:
        return mod
    eng, _ = _load_edited(RAGGED, tag + "_engine")
    for attr, value in vars(real).items():
        if callable(value) and eng.__dict__.get(attr) is value:
            eng.__dict__[attr] = getattr(mod, attr)
    return eng


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
        rcfg = ragged.RaggedConfig(**smoke.ENGINE, device_state=False)
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
        # the device path: correct engine, then each Python mutant
        use(_build, libs["correct"])
        cfg2 = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
        for tag in ["correct", *PY_MUTANTS]:
            mod = ragged if tag == "correct" else mutant_module(tag)
            res = smoke.parity_device(torch, np, llama, mod)
            row = rows.setdefault(tag, {"variant": tag})
            row["parity_device_fp32"] = {
                k: res[k] for k in ("device_tokens_identical", "run_ahead_tokens_identical",
                                    "fused_device_tokens_identical",
                                    "fused_host_staged_tokens_identical", "graph_replays")}
            row["parity_sched_fp32"] = {name: v["tokens_identical"]
                                        for name, v in res["sched"].items()}
            eng = mod.RaggedInferenceEngine(llama.build(cfg2),
                                            mod.RaggedConfig(**smoke.ENGINE, **smoke.FUSED),
                                            dtype=torch.float32, seed=1)
            res = smoke.fused_program_check(torch, np, eng)
            row["fused_program_fp32"] = {
                k: res[k] for k in ("bit_identical", "kv_rows_written_outside_schedule",
                                    "kv_rows_missing",
                                    "frozen_and_retired_rows_surface_minus_one")}
            del eng
            eng = mod.RaggedInferenceEngine(llama.build(cfg2),
                                            mod.RaggedConfig(**smoke.ENGINE, **smoke.SCHED),
                                            dtype=torch.float32, seed=1)
            res = smoke.sched_program_check(torch, np, eng)
            row["sched_program_fp32"] = {
                k: res[k] for k in ("bit_identical", "steps_as_probed", "iterations",
                                    "deepest_row_steps", "kv_rows_written_outside_schedule",
                                    "kv_rows_missing", "full_iterations",
                                    "early_exit_iterations", "all_retired_iterations")}
            del eng
            torch.cuda.empty_cache()
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
