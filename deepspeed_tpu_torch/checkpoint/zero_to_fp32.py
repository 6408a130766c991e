"""Consolidate a checkpoint into one full-precision state file (counterpart
of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``).

The on-disk format is already universal (every fragment in a leaf's global
coordinates, ``checkpoint/sharded.py``), so consolidation is conversion: a
sharded or legacy tag's model tree -> one ``.npz`` or a ``.pt`` written
with ``torch.save``, keyed by dotted names (``layers.wq``), fp32.

Usage:
    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz|out.pt>
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import engine as ckpt_engine


def _dotted(key: str) -> str:
    return key.replace("['", "").replace("']", ".").rstrip(".")


def get_fp32_state_dict_from_checkpoint(ckpt_dir: str, tag: str | None = None
                                        ) -> dict[str, np.ndarray]:
    """{dotted name: fp32 array} of the model tree of ``tag`` (default: the
    ``latest`` pointer's, else ``ckpt_dir`` itself)."""
    return {_dotted(key): np.asarray(arr).astype(np.float32)
            for key, arr in ckpt_engine.model_tree(ckpt_dir, tag)}


def convert_checkpoint_to_fp32_state_file(ckpt_dir: str, output_path: str,
                                          tag: str | None = None) -> None:
    state = get_fp32_state_dict_from_checkpoint(ckpt_dir, tag)
    if output_path.endswith(".pt"):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
                   output_path)
    else:
        np.savez(output_path, **state)
    total = sum(v.size for v in state.values())
    print(f"wrote {len(state)} tensors ({total:,} params) to {output_path}")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 1
    convert_checkpoint_to_fp32_state_file(sys.argv[1], sys.argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
