"""Build the port's CUDA sources (``csrc/*.cu``) and load them with ctypes.

Role of ``deepspeed_tpu/ops/op_builder.py``. Each kernel source compiles,
with ``nvcc`` alone, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The library lands in ``.dstpu_torch_build/`` at the repository root (listed
in ``.gitignore``), named by a hash of the flags and every source in
``csrc/``, so an edited source rebuilds and an unchanged one is reused.
``ptxas``' report (registers, shared memory, spills) is kept beside it.
Nothing builds at import: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".dstpu_torch_build"
KERNELS = ("paged_decode", "paged_prefill", "flash_fwd", "flash_bwd", "wide_head")
# every source: the kernels, and the loop-graph composer the engine's
# scheduler programs replay through (it computes nothing)
SOURCES = (*KERNELS, "graph_loop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds nvcc took for each source this process compiled
BUILD_SECONDS: dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its stderr."""


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {name} (rc {proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names=SOURCES) -> dict[str, Path]:
    """Build every source at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        futures = {n: ex.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(name: str) -> list[dict]:
    """Per-kernel registers, static shared memory and spills from the
    ``-Xptxas -v`` log of the built library."""
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


def parse_ptxas(log: str) -> list[dict]:
    """Per-kernel registers, static shared memory and spills from the text
    ``-Xptxas -v`` prints."""
    rows: list[dict] = []
    cur: dict | None = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["static_smem_bytes"] = int(m.group(2) or 0)
    return rows
