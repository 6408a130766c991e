"""Checkpoint commit protocol, verification and the tag ladder (counterpart
of ``deepspeed_tpu/checkpoint/engine.py``; the same layout on disk).

Layout per checkpoint:
    {save_dir}/{tag}/manifest.json     config dump + counters + client state
                                       + per-file sizes and sha256 checksums
    {save_dir}/{tag}/*.npz             sharded fragment payloads (sharded.py)
    {save_dir}/{tag}/*.index.json      per-tree fragment indexes
    {save_dir}/latest                  text file holding the newest tag

Two-phase commit:

1. **Prepare**: every file is written into ``{save_dir}/.tmp-{tag}/`` (the
   staging dir), fsynced, and checksummed; the manifest, carrying the file
   table, is written last, atomically.
2. **Commit**: one ``os.replace`` promotes the staging dir to
   ``{save_dir}/{tag}``, then an atomic temp+rename+fsync updates ``latest``.

A kill at any instruction leaves either the previous committed state or
the new one: partial writes live only under a ``.tmp-*`` name that loaders
and rotation skip, and ``latest`` moves only after the directory it names
is durable. ``verify_checkpoint`` re-derives the file checksums so on-disk
corruption is caught before any engine state is touched; ``fallback_tags``
gives loaders the tag ladder (ordered by the step parsed from the tag,
never by mtime) to walk on corruption. The checkpoint seams fire the fault
points ``serving/faults.py`` names (``ckpt.commit``, ``ckpt.latest`` here;
``ckpt.collect``, ``ckpt.flush`` and ``ckpt.load`` in the engine).

The port writes the sharded format only; it reads the JAX package's
legacy single-file layout too (``CheckpointEngine``'s ``model.npz``, in
:func:`model_tree` and the training engine). Two differences of method,
none of format: files are fsynced and hashed one thread a file,
and ``verify_checkpoint`` checks every file's presence and size before it
hashes any, so a truncated file fails without a hash pass (the reference
goes file by file; with several corruptions at once the two can name
different first stages).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor

from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.checkpoint import sharded
from deepspeed_tpu_torch.utils.logging import log_dist

MANIFEST = "manifest.json"
TMP_PREFIX = ".tmp-"
_STEP_RE = re.compile(r"(\d+)\s*$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification. ``stage`` names what broke
    (``latest-unreadable`` / ``manifest-missing`` / ``manifest-unreadable`` /
    ``uncommitted`` / ``file-missing`` / ``size-mismatch`` /
    ``checksum-mismatch`` / ``fragment-missing`` / ``fragment-coverage`` /
    ``exhausted``) and labels ``checkpoint_corrupt_total``."""

    def __init__(self, message: str, stage: str = "unknown", tag: str = ""):
        super().__init__(message)
        self.stage = stage
        self.tag = tag


def _fire(point: str, path: str | None = None) -> None:
    """Checkpoint-seam fault injection."""
    from deepspeed_tpu_torch.serving import faults

    faults.get_fault_injector().fire(point, path=path)


# --------------------------------------------------------------- latest pointer
def latest_tag(save_dir: str) -> str | None:
    """Read the ``latest`` pointer. An unreadable or garbage pointer (crash
    residue from a pre-atomic writer, disk corruption) is reported — counter
    ``checkpoint_corrupt_total{stage=latest-*}`` — and returns ``None`` so
    callers fall back to the on-disk tag ladder instead of chasing garbage."""
    path = os.path.join(save_dir, "latest")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            tag = f.read().strip()
    except OSError as e:
        _note_corrupt("latest-unreadable", f"latest pointer unreadable: {e}")
        return None
    if not tag or len(tag) > 512 or any(c in tag for c in "\0\n/\\"):
        _note_corrupt(
            "latest-garbage",
            f"latest pointer holds garbage ({tag[:64]!r}); ignoring")
        return None
    return tag


def model_tree(ckpt_dir: str, tag: str | None = None):
    """Yield ``(keystr, full array)`` of every leaf of a tag's ``model``
    tree, one leaf at a time: of ``tag``, else of the ``latest`` pointer's,
    else of ``ckpt_dir`` itself; sharded (``sharded.assemble_full``: a leaf
    that is one fragment comes memory-mapped) or the legacy ``model.npz``.
    The readers of a whole model (``zero_to_fp32``, the inference engine's
    load) go through here."""
    tag = tag or latest_tag(ckpt_dir)
    base = os.path.join(ckpt_dir, tag) if tag else ckpt_dir
    if sharded.is_sharded(base, "model"):
        yield from sharded.assemble_full(base, "model")
        return
    yield from ser.iter_arrays(os.path.join(base, "model.npz"))


def write_latest(save_dir: str, tag: str) -> None:
    """Atomically move the ``latest`` pointer: temp file + fsync +
    ``os.replace`` + dir fsync. The pointer is the last word of the commit —
    it only ever names a fully committed tag."""
    _fire("ckpt.latest", path=os.path.join(save_dir, "latest"))
    ser.atomic_write_text(os.path.join(save_dir, "latest"), str(tag))


def _note_corrupt(stage: str, message: str) -> None:
    from deepspeed_tpu_torch.telemetry import TELEMETRY

    log_dist(f"checkpoint: {message}", ranks=[0])
    if TELEMETRY.enabled:
        TELEMETRY.counter(
            "checkpoint_corrupt_total",
            "checkpoint integrity failures, by verification stage",
        ).inc(stage=stage)


# ------------------------------------------------------------- commit protocol
def staging_dir(save_dir: str, tag: str) -> str:
    """The prepare-phase directory for ``tag``. Dot-prefixed so every tag
    scan (rotation, fallback ladder, loaders) skips it."""
    return os.path.join(save_dir, f"{TMP_PREFIX}{tag}")


def file_digest(path: str, chunk: int = 1 << 24) -> tuple[int, str]:
    """Streaming (size, sha256-hex) of a file — never materializes it."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            n += len(block)
            h.update(block)
    return n, h.hexdigest()


def build_file_table(ckpt_dir: str, fsync: bool = True) -> dict[str, dict]:
    """Checksum every regular file in ``ckpt_dir`` (except the manifest,
    which cannot self-reference): ``{name: {"bytes": n, "sha256": hex}}``.
    With ``fsync`` the files are made durable as they are hashed — the
    prepare phase's durability barrier."""
    names = [fn for fn in sorted(os.listdir(ckpt_dir))
             if fn != MANIFEST and os.path.isfile(os.path.join(ckpt_dir, fn))]

    paths = [os.path.join(ckpt_dir, fn) for fn in names]
    # the fsyncs (the disk's time) and the hashes (the CPU's, from the page
    # cache) of every file run at once; the barrier holds when all are done
    jobs = [(file_digest, p) for p in paths] + [(ser.fsync_file, p) for p in paths
                                                if fsync]
    results = _each_file(lambda job: job[0](job[1]), jobs)
    return {fn: {"bytes": size, "sha256": digest}
            for fn, (size, digest) in zip(names, results)}


def _each_file(fn, items: list) -> list:
    """``fn`` over ``items`` on a thread each: hashing and fsync release the
    GIL, so a rank's model and optimizer files are hashed at once."""
    if len(items) <= 1:
        return [fn(n) for n in items]
    with ThreadPoolExecutor(min(len(items), 16)) as pool:
        return list(pool.map(fn, items))


def commit_checkpoint(save_dir: str, tag: str, manifest: dict) -> str:
    """Phase 2: checksum + fsync the staged files, write the manifest (the
    commit record) atomically into the staging dir, then promote the whole
    directory with one ``os.replace`` and fsync the parent. Returns the
    final checkpoint dir."""
    stage = staging_dir(save_dir, tag)
    final = os.path.join(save_dir, str(tag))
    manifest = dict(manifest)
    manifest["files"] = build_file_table(stage, fsync=True)
    manifest["commit_protocol"] = 2
    ser.save_json(os.path.join(stage, MANIFEST), manifest)
    ser.fsync_dir(stage)
    # a kill between here and the replace leaves a complete .tmp dir and an
    # untouched previous checkpoint — exactly the "old state" outcome
    _fire("ckpt.commit", path=os.path.join(stage, MANIFEST))
    if os.path.isdir(final):
        # re-saving an existing tag: move the old dir aside first so the
        # promote below lands on a free name (rename-onto-nonempty fails)
        doomed = os.path.join(save_dir, f"{TMP_PREFIX}doomed.{tag}.{os.getpid()}")
        os.rename(final, doomed)
        shutil.rmtree(doomed, ignore_errors=True)
    os.replace(stage, final)  # THE commit point
    ser.fsync_dir(save_dir)
    return final


# ----------------------------------------------------------------- verification
def _index_names(ckpt_dir: str) -> set[str]:
    """Tree names with either a merged index or partial-index residue."""
    names = set()
    for p in glob.glob(os.path.join(ckpt_dir, "*.index.json")):
        names.add(os.path.basename(p)[: -len(".index.json")])
    for p in glob.glob(os.path.join(ckpt_dir, "*.index.p*.json")):
        names.add(os.path.basename(p).split(".index.p")[0])
    return names


def _verify_indexes(ckpt_dir: str, tag: str) -> None:
    """Structural checks shared by v2 and legacy checkpoints: every tree
    with fragments must have a MERGED index (partial ``.index.p*.json``
    residue without one = a crash between the per-process writes and
    ``finalize_index`` — the checkpoint never committed), every fragment's
    file must exist, and the fragments of each leaf must cover it."""
    for name in sorted(_index_names(ckpt_dir)):
        merged = os.path.join(ckpt_dir, f"{name}.index.json")
        if not os.path.exists(merged):
            raise CheckpointCorruptError(
                f"{tag}: {name} has partial index files but no merged "
                f"{name}.index.json (crash before finalize_index) — "
                "uncommitted", stage="uncommitted", tag=tag)
        try:
            with open(merged) as f:
                index = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"{tag}: {name}.index.json unreadable: {e}",
                stage="index-unreadable", tag=tag) from e
        for key, meta in index.items():
            covered = 0
            for frag in meta.get("fragments", ()):
                fpath = os.path.join(ckpt_dir, frag["file"])
                if not os.path.exists(fpath):
                    raise CheckpointCorruptError(
                        f"{tag}: fragment file {frag['file']} (leaf {key}) "
                        "missing", stage="fragment-missing", tag=tag)
                vol = 1
                for start, stop in frag["index"]:
                    vol *= max(0, stop - start)
                covered += vol
            size = 1
            for d in meta.get("shape", ()):
                size *= d
            if covered < size:
                raise CheckpointCorruptError(
                    f"{tag}: fragments cover {covered}/{size} elements of "
                    f"leaf {key}", stage="fragment-coverage", tag=tag)


def verify_checkpoint(ckpt_dir: str, deep: bool = True) -> dict:
    """Validate a checkpoint dir before anyone trusts it. Returns the parsed
    manifest on success; raises :class:`CheckpointCorruptError` naming the
    failing stage otherwise.

    Checks, in order: the dir is not a staging dir; the manifest exists and
    parses; every file in the manifest's table exists with the recorded size
    and (``deep``) sha256; every fragment index is merged, complete, and
    covers its leaves. Pre-protocol checkpoints (no ``files`` table) get the
    structural checks only and are reported as legacy."""
    tag = os.path.basename(ckpt_dir.rstrip("/"))
    if tag.startswith(TMP_PREFIX):
        raise CheckpointCorruptError(
            f"{tag}: staging dir was never promoted (crash mid-save)",
            stage="uncommitted", tag=tag)
    mpath = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"{tag}: no manifest.json (uncommitted or not a checkpoint)",
            stage="manifest-missing", tag=tag)
    try:
        manifest = ser.load_json(mpath)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{tag}: manifest.json unreadable: {e}",
            stage="manifest-unreadable", tag=tag) from e
    files = manifest.get("files")
    if files is None:
        # legacy (pre-commit-protocol) checkpoint: no checksums to check
        _verify_indexes(ckpt_dir, tag)
        return manifest
    # existence and sizes of every file first (no hash pass over a
    # checkpoint with a truncated file), then the checksums, hashed at once
    for fn, meta in files.items():
        path = os.path.join(ckpt_dir, fn)
        if not os.path.exists(path):
            raise CheckpointCorruptError(
                f"{tag}: {fn} listed in manifest but missing on disk",
                stage="file-missing", tag=tag)
        size = os.path.getsize(path)
        if size != int(meta["bytes"]):
            raise CheckpointCorruptError(
                f"{tag}: {fn} is {size}B, manifest says {meta['bytes']}B "
                "(truncated?)", stage="size-mismatch", tag=tag)
    if deep:
        names = list(files)
        digests = _each_file(lambda fn: file_digest(os.path.join(ckpt_dir, fn))[1], names)
        for fn, digest in zip(names, digests):
            if digest != files[fn]["sha256"]:
                raise CheckpointCorruptError(
                    f"{tag}: {fn} sha256 mismatch (on-disk corruption)",
                    stage="checksum-mismatch", tag=tag)
    _verify_indexes(ckpt_dir, tag)
    _verify_pipeline_fragments(ckpt_dir, tag, manifest)
    return manifest


def _verify_pipeline_fragments(ckpt_dir: str, tag: str, manifest: dict) -> None:
    """A staged-pipeline checkpoint's manifest records which per-stage
    fragment files it expects (``manifest["pipeline"]["fragments"]``); the
    generic file table would also catch a missing one, but cross-checking
    here names the STAGE that lost its shard instead of just the file."""
    pipe = manifest.get("pipeline")
    if not isinstance(pipe, dict):
        return
    for stage, names in (pipe.get("fragments") or {}).items():
        for fn in names:
            if not os.path.exists(os.path.join(ckpt_dir, fn)):
                raise CheckpointCorruptError(
                    f"{tag}: pipeline stage {stage} fragment {fn} is "
                    "missing (manifest declares "
                    f"{pipe.get('stages')} stages)",
                    stage="pipeline-fragments", tag=tag)


# ------------------------------------------------------------------ tag ladder
def tag_step(tag: str) -> int:
    """The step number parsed from a tag's trailing digits (``global_step120``
    → 120); tags without one sort below all numbered tags."""
    m = _STEP_RE.search(str(tag))
    return int(m.group(1)) if m else -1


def list_tags(save_dir: str, newest_first: bool = True) -> list[str]:
    """Candidate checkpoint tags under ``save_dir``: non-hidden directories
    holding a manifest, ordered by the step parsed from the tag (mtime only
    as tiebreak — a half-written crash residue must never outrank a good
    checkpoint just because its mtime is newer)."""
    if not os.path.isdir(save_dir):
        return []
    tags = []
    for d in os.listdir(save_dir):
        path = os.path.join(save_dir, d)
        if d.startswith(".") or not os.path.isdir(path):
            continue
        if not os.path.exists(os.path.join(path, MANIFEST)):
            continue  # uncommitted residue: not a checkpoint
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        tags.append((tag_step(d), mtime, d))
    tags.sort(reverse=newest_first)
    return [t for _, _, t in tags]


def fallback_tags(save_dir: str, failed: str | None = None) -> list[str]:
    """The verification ladder after ``failed`` didn't verify: every other
    candidate tag, newest first by parsed step."""
    return [t for t in list_tags(save_dir) if t != failed]


def rotate_checkpoints(save_dir: str, keep_n: int,
                       protect: str | None = None) -> None:
    """Delete the oldest committed tags beyond ``keep_n`` (0 = keep all).

    Ordering is by the step parsed from the tag (mtime tiebreak only);
    ``.tmp-*`` staging dirs and uncommitted residue are skipped entirely
    (neither counted against ``keep_n`` nor deleted); the tag ``latest``
    points to — and ``protect``, usually the tag just written — survive even
    when ``keep_n`` would evict them."""
    if keep_n <= 0:
        return
    keep = {t for t in (latest_tag(save_dir), protect) if t}
    tags = list_tags(save_dir, newest_first=False)  # oldest first
    excess = len(tags) - keep_n
    for d in tags:
        if excess <= 0:
            break
        if d in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)
        excess -= 1
        log_dist(f"rotated out checkpoint {d}", ranks=[0])
