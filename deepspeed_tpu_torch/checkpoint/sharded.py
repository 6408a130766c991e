"""Sharded checkpoint format: per-rank fragment files + per-leaf index
(counterpart of ``deepspeed_tpu/checkpoint/sharded.py``, the same format on
disk).

Layout per tree (e.g. ``model``):
    {ckpt}/{name}.index.json          leaf -> shape/dtype + fragment records
    {ckpt}/{name}_shard_p{rank}.npz   this rank's fragment payloads

A fragment record is ``{"file", "member", "index"}``: the npz file, the
member in it (``{keystr}#frag{i}``, ``/`` escaped) and the fragment's box
in the leaf's global coordinates, ``[[start, stop], ...]`` a dimension.
Each rank writes the fragments it holds uniquely (a replicated leaf: rank
0; a sharded one: the ranks of data coordinate 0, one box each), so the
bytes written across ranks are the state's size. A multi-rank save writes
partial indexes (``{name}.index.p{rank}.json``) that rank 0 merges after a
barrier (``finalize_index``).

Loading pastes, into each box this rank needs, every fragment that
overlaps it: any world size, mesh or ZeRO stage loads any other, and a
checkpoint of the JAX package (whose fragments are device shards) loads as
one of the port's does.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import zipfile

import numpy as np

from deepspeed_tpu_torch.checkpoint.serialization import to_numpy

__all__ = ["collect_fragments", "write_fragments", "finalize_index", "load_sharded",
           "assemble_full", "is_sharded"]


def _member(key: str, i: int) -> str:
    return f"{key}#frag{i}".replace("/", "\\slash ")


def is_sharded(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f"{name}.index.json"))


def collect_fragments(leaves: list, name: str, rank: int = 0) -> tuple[dict, dict]:
    """Snapshot this rank's fragments to host numpy.

    ``leaves``: ``(key, global_shape, dtype, fragments)`` for every leaf of
    the tree, where ``fragments`` is a list of ``(box, tensor_or_array)``
    this rank writes (empty when another rank writes the leaf) and
    ``dtype`` the numpy dtype the index records. Returns ``(payload,
    index)``; the host copies are the double buffer of an async save."""
    payload: dict[str, np.ndarray] = {}
    index: dict = {}
    fname = f"{name}_shard_p{rank}.npz"
    for key, shape, dtype, frags in leaves:
        records = []
        for box, value in frags:
            data = to_numpy(value)
            if data.dtype != np.dtype(dtype):
                data = data.astype(dtype)
            member = _member(key, len(records))
            payload[member] = data
            records.append({"file": fname, "member": member,
                            "index": [list(b) for b in box]})
        index[key] = {"shape": list(shape), "dtype": str(np.dtype(dtype)),
                      "fragments": records}
    return payload, index


def write_fragments(ckpt_dir: str, name: str, payload: dict, index: dict,
                    rank: int = 0, world_size: int = 1) -> None:
    """Flush a collected payload + index (sync; callers may run it on a
    writer thread). A multi-rank save writes a partial index."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(os.path.join(ckpt_dir, f"{name}_shard_p{rank}.npz"), **payload)
    path = (f"{name}.index.json" if world_size == 1
            else f"{name}.index.p{rank}.json")
    with open(os.path.join(ckpt_dir, path), "w") as f:
        json.dump(index, f)


def finalize_index(ckpt_dir: str, name: str) -> None:
    """Merge per-rank partial indices into ``{name}.index.json``. Call on
    rank 0 after a barrier following every rank's ``write_fragments``; a
    no-op for single-rank saves."""
    parts = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}.index.p*.json")))
    if not parts:
        return
    index: dict = {}
    for path in parts:
        with open(path) as f:
            other = json.load(f)
        for key, meta in other.items():
            mine = index.setdefault(key, {**meta, "fragments": []})
            mine["fragments"] = mine["fragments"] + meta["fragments"]
    with open(os.path.join(ckpt_dir, f"{name}.index.json"), "w") as f:
        json.dump(index, f)
    for path in parts:
        os.remove(path)


def _overlap(dst_idx, src_idx):
    """Intersection of two [[start, stop], ...] boxes -> (dst slices, src
    slices) or None."""
    dst_sl, src_sl = [], []
    for (ds, de), (ss, se) in zip(dst_idx, src_idx):
        lo, hi = max(ds, ss), min(de, se)
        if lo >= hi:
            return None
        dst_sl.append(slice(lo - ds, hi - ds))
        src_sl.append(slice(lo - ss, hi - ss))
    return tuple(dst_sl), tuple(src_sl)


class _FragmentReader:
    """Npz member access across the checkpoint's shard files. A member
    stored uncompressed (``np.savez``'s, either package's) is mapped from the
    file in place, copy-on-write, instead of read through ``zipfile``: the
    checksums of ``verify_checkpoint`` cover the bytes, so the zip CRC pass
    and the copy are skipped. Anything else reads through ``np.load``."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._files: dict = {}

    def get(self, frag: dict) -> np.ndarray:
        entry = self._files.get(frag["file"])
        if entry is None:
            path = os.path.join(self.ckpt_dir, frag["file"])
            with zipfile.ZipFile(path) as z:
                infos = {i.filename: i for i in z.infolist()}
            entry = (path, infos, np.load(path, allow_pickle=False))
            self._files[frag["file"]] = entry
        path, infos, npz = entry
        info = infos.get(frag["member"] + ".npy")
        mapped = (_map_member(path, info) if info is not None
                  and info.compress_type == zipfile.ZIP_STORED else None)
        return npz[frag["member"]] if mapped is None else mapped

    def close(self):
        for _, _, npz in self._files.values():
            npz.close()


def _map_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """The ``.npy`` payload of an uncompressed zip member, memory-mapped
    (``None`` for a ``.npy`` version this does not parse)."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"{path}: bad local header for {info.filename}")
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        if version not in ((1, 0), (2, 0)):
            return None
        header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                  else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = header(f)
        offset = f.tell()
    if dtype.hasobject:
        raise ValueError(f"{path}: object arrays are not checkpoint payloads")
    if not shape or 0 in shape:
        return np.fromfile(path, dtype=dtype, count=int(np.prod(shape)),
                           offset=offset).reshape(shape)
    return np.memmap(path, dtype=dtype, mode="c", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def read_index(ckpt_dir: str, name: str) -> dict:
    with open(os.path.join(ckpt_dir, f"{name}.index.json")) as f:
        return json.load(f)


def assemble_full(ckpt_dir: str, name: str, dtype=None):
    """Yield ``(key, full array)`` of every leaf of a sharded tree, one leaf
    materialized at a time (``zero_to_fp32``, the inference engine's load).
    ``dtype``: the arrays' dtype, else the index's."""
    index = read_index(ckpt_dir, name)
    for key, meta in index.items():
        shape = tuple(meta["shape"])
        yield key, load_sharded([(key, shape, [[0, d] for d in shape],
                                  dtype or np.dtype(meta["dtype"]))], ckpt_dir, name)[key]


def load_sharded(targets: list, ckpt_dir: str, name: str, strict: bool = True) -> dict:
    """Assemble the boxes this rank needs. ``targets``: ``(key, global_shape,
    box, dtype)`` with ``box`` in global coordinates (``[[0, d], ...]`` for a
    whole leaf). Returns {key: numpy array of the box in ``dtype``}; a key
    missing from the checkpoint raises with ``strict`` and is left out
    otherwise. Every element of a box must be covered by some fragment."""
    index = read_index(ckpt_dir, name)
    reader = _FragmentReader(ckpt_dir)
    out = {}
    try:
        for key, shape, box, dtype in targets:
            meta = index.get(key)
            if meta is None:
                if strict:
                    raise KeyError(f"checkpoint missing leaf {key}")
                continue
            if tuple(meta["shape"]) != tuple(shape):
                raise ValueError(f"checkpoint leaf {key} shape {tuple(meta['shape'])} != "
                                 f"expected {tuple(shape)}")
            frags = meta["fragments"]
            exact = [f for f in frags if f["index"] == [list(b) for b in box]]
            if exact and np.dtype(meta["dtype"]) == np.dtype(dtype):
                # one fragment is the box: its mapped payload, as it is
                out[key] = reader.get(exact[0])
                continue
            buf = np.zeros([e - s for s, e in box], np.dtype(dtype))
            # coverage by mask, not by summed volumes: fragments may overlap
            mask = np.zeros(buf.shape, bool)
            for frag in frags:
                ov = _overlap(box, frag["index"])
                if ov is None:
                    continue
                data = reader.get(frag)
                buf[ov[0]] = data[ov[1]].astype(buf.dtype)
                mask[ov[0]] = True
            if not mask.all():
                raise ValueError(f"checkpoint fragments cover {int(mask.sum())}/{buf.size} "
                                 f"elements of {key} shard")
            out[key] = buf
    finally:
        reader.close()
    return out
