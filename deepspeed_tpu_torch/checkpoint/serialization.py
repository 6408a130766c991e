"""Tree <-> on-disk array serialization (counterpart of
``deepspeed_tpu/checkpoint/serialization.py``).

A tree here is what the port keeps its state in: nested dicts of tensors
(or numpy arrays, or Python numbers). Each leaf is addressed by the key the
JAX package gives it, ``jax.tree_util.keystr`` of its path:
``['layers']['wq']`` for a dict path, so a checkpoint written by either
package names its leaves the same way. A key that is already a ``keystr``
prefix (``"[0].mu"``, an optimizer state field) is joined as it is.

bf16 has no numpy dtype: a bf16 leaf is written as float32 (the form the
JAX package's ``np.asarray`` of a bf16 array takes on the host is
``ml_dtypes.bfloat16``, which the port cannot write either) and a loader
casts to its template's dtype. Masters and optimizer moments are fp32.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys; a ``str`` element that
    starts with ``[`` or ``.`` is an already-rendered key and is joined as is."""
    out = []
    for k in path:
        if isinstance(k, str) and k[:1] in ("[", "."):
            out.append(k)
        else:
            out.append(f"[{k!r}]")
    return "".join(out)


def flatten_with_keys(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(keystr, leaf) of every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_keys(v, prefix + (k,))
    else:
        yield keystr(prefix), tree


def to_numpy(leaf) -> np.ndarray:
    """A copy of a leaf on the host as numpy (of a CUDA tensor: the one
    explicit device -> host copy; of a CPU tensor: a copy too, so training
    on after it cannot change it); bf16 widens to fp32; Python numbers
    become 0-d arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def tree_to_arrays(tree: Any) -> dict[str, np.ndarray]:
    """Flatten a tree into {keystr: full numpy array}."""
    return {k: to_numpy(v) for k, v in flatten_with_keys(tree)}


def arrays_to_tree(template: Any, arrays: dict[str, np.ndarray], strict: bool = True,
                   prefix: tuple = ()) -> Any:
    """Rebuild a nested dict congruent to ``template`` from saved arrays;
    tensors follow the template's dtype and device."""
    if isinstance(template, dict):
        return {k: arrays_to_tree(v, arrays, strict, prefix + (k,))
                for k, v in template.items()}
    key = keystr(prefix)
    if key not in arrays:
        if strict:
            raise KeyError(f"checkpoint missing leaf {key}")
        return template
    arr = arrays[key]
    shape = tuple(template.shape) if hasattr(template, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != expected {shape}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=template.dtype, device=template.device)
    return type(template)(arr.item()) if np.ndim(template) == 0 else arr


def iter_arrays(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """``(keystr, array)`` of each member of one ``.npz`` of keystr-named
    arrays (the legacy single-file layout), read one at a time; ``/`` is
    unescaped as the JAX package escapes it."""
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            yield k.replace("\\slash ", "/"), z[k]


def load_arrays(path: str) -> dict[str, np.ndarray]:
    return dict(iter_arrays(path))


def fsync_file(path: str) -> None:
    """fsync an already-written file by path (durability barrier)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable. A no-op
    on filesystems that reject O_RDONLY dir fds (e.g. some network mounts)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Crash-safe text write: temp file in the same directory + fsync +
    ``os.replace`` + directory fsync. A kill at any instruction leaves either
    the old content or the new, never a truncated file."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(d)


def save_json(path: str, obj: dict) -> None:
    """Atomic JSON write (temp + fsync + rename)."""
    atomic_write_text(path, json.dumps(obj, indent=2, default=str))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
