#!/usr/bin/env python3
"""Whether this checkout compiles kernels to the same machine code as
another checkout, on the card's machine (it needs nvcc and cuobjdump).

Each source of ``deepspeed_tpu_torch/ops/cuda/csrc`` is compiled from both
trees with this checkout's nvcc flags, all at once. For every kernel
function whose mangled name contains one of ``--kernels`` the script
compares the SASS that ``cuobjdump -sass`` prints and ptxas' registers and
spills, with the per-build hash of the anonymous namespace stripped from
names. It prints one JSON line per source and exits 1 if a selected kernel
differs or is missing from either build. Run from the repository root,
e.g. against an unpacked ``git archive`` of the parent commit:

    python3 chip_sass_diff.py --against runs/parent --kernels wgmma
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from deepspeed_tpu_torch.ops.cuda import _build

CSRC = Path("deepspeed_tpu_torch/ops/cuda/csrc")
# nvcc names the anonymous namespace after the file and a per-build hash
_ANON = re.compile(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]+|_GLOBAL__N__[0-9a-f]+")


def _plain(name: str) -> str:
    return _ANON.sub("ANON", name)


def compile_tree(tree: Path, name: str, out: Path) -> tuple[dict, dict]:
    """(SASS by kernel, ptxas report by kernel) of csrc/<name>.cu in tree."""
    lib = out / f"{tree.name}-{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(tree / CSRC / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise _build.KernelBuildError(f"nvcc failed for {tree}/{name}:\n{proc.stderr}")
    dump = subprocess.run([str(Path(_build.find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True, check=True).stdout
    sass: dict[str, list[str]] = {}
    cur = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = sass.setdefault(_plain(m.group(1)), [])
        elif cur is not None and line.strip():
            cur.append(_plain(line.strip()))
    ptxas = {}
    for row in _build.parse_ptxas(proc.stderr):
        fn = _plain(row.pop("function"))
        ptxas[fn] = row
    return sass, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, type=Path, help="the other checkout's root")
    ap.add_argument("--kernels", nargs="+", required=True,
                    help="substrings of the mangled kernel names to compare")
    args = ap.parse_args()
    failed = False
    with tempfile.TemporaryDirectory(prefix="dstpu-sass-") as tmp, \
            ThreadPoolExecutor(max_workers=2 * len(_build.KERNELS)) as ex:
        # a source only one tree has counts as an empty build in the other
        jobs = {(tree, name): ex.submit(compile_tree, tree, name, Path(tmp))
                for tree in (Path("."), args.against) for name in _build.KERNELS
                if (tree / CSRC / f"{name}.cu").exists()}
        for name in _build.KERNELS:
            (ours, our_regs), (theirs, their_regs) = (
                jobs[(t, name)].result() if (t, name) in jobs else ({}, {})
                for t in (Path("."), args.against))
            picked = sorted(f for f in set(ours) | set(theirs)
                            if any(k in f for k in args.kernels))
            rows = []
            for fn in picked:
                same = ours.get(fn) == theirs.get(fn) and fn in ours
                rows.append(dict(function=fn, sass_identical=same,
                                 instructions=[len(ours.get(fn, [])), len(theirs.get(fn, []))],
                                 ptxas=[our_regs.get(fn), their_regs.get(fn)]))
                failed |= not same or our_regs.get(fn) != their_regs.get(fn)
            print(json.dumps({"source": name, "kernels": rows}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
