"""Hierarchical KV-cache tiering: HBM → host RAM → disk (counterpart of
``deepspeed_tpu/inference/kvtier.py``, copied whole: it is host-only code).

The paged prefix cache (``inference/ragged.py``) is strictly free-HBM-funded:
when the allocator's LRU runs dry the evicted block's KV is simply gone and
the next request re-prefills it from scratch. This module turns that eviction
into a *demotion* down a three-tier store, the same memory-hierarchy
discipline the reference framework applies to optimizer/parameter state
(swap_tensor pinned pools, ZeRO-Infinity NVMe):

- **tier 0** — the device-resident block pool itself (owned by the engine;
  this module never touches device memory).
- **tier 1** — :class:`HostTier`, a bounded host-RAM arena. The engine's
  demote hook gathers the evicted block's payload device→host (the same
  block-row gather ``export_handoff`` uses) and parks it here keyed
  by the block's exact hash-chain key.
- **tier 2** — :class:`DiskTier`, a spill directory fed by tier-1 overflow.
  Records are written with the checkpoint commit protocol (same-dir temp +
  fsync + ``os.replace``) and length+sha256 framing, so a torn or corrupted
  record can never splice wrong KV — it is detected and discarded.

Promotion back to HBM is cost-model driven: :func:`restore_beats_prefill`
compares the tier-crossing byte time against re-running prefill for the same
tokens (the serving cluster's ``transfer_beats_prefill`` model applied to tier bandwidth
instead of wire bandwidth), and is conservative on unknowns — a non-positive
bandwidth or prefill rate never restores. The engine performs the actual
restore through its standard allocate→scatter→publish path, so a promoted
block re-enters the tier-0 LRU exactly as if it had never left and the
admission splice (and therefore the emitted tokens) is bit-identical either
way.

Async prefetch: the serving router calls ``prefetch()`` at placement time
with the chain keys the chosen replica is missing from HBM; a worker thread
stages matching disk records up into the host arena so the admission-time
restore only pays the host→device hop. A prefetch that has not finished by
admission is *abandoned* (the admission pass restores synchronously or
re-prefills) — token-identical either way, only the latency differs.

Everything here is plain host state behind one lock; the module never
imports the engine, so ``ragged.py`` can import the framing helpers for
``KVHandoff.to_bytes``/``from_bytes`` without a cycle.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue
import struct
import threading
import time
from typing import Any

import numpy as np

__all__ = [
    "DiskTier",
    "HostTier",
    "KVCodecMismatch",
    "KVTierStore",
    "frame_bytes",
    "restore_beats_prefill",
    "unframe_bytes",
]


class KVCodecMismatch(ValueError):
    """A persisted KV record was written under a different quantization
    codec than this engine runs (``RaggedConfig.quant``). Dequantizing it
    anyway would splice numerically wrong KV, so reads RAISE instead of
    missing — unlike corruption, which reads as a miss, a codec mismatch
    is a configuration error the operator must see."""

# framing magics: one for tier-2 spill records, one for serialized KVHandoff
# payloads (shared integrity check, distinct container types)
RECORD_MAGIC = b"KVT2"
HANDOFF_MAGIC = b"KVH1"
_FRAME_HEADER = struct.Struct("<Q")  # u64 body length, then sha256, then body


# --------------------------------------------------------------- framing
def frame_bytes(body: bytes) -> bytes:
    """Wrap ``body`` in length+sha256 framing: u64 little-endian length,
    32-byte sha256 digest, then the body. Shared by the disk tier's spill
    records and ``KVHandoff.to_bytes`` so every serialized KV payload in the
    system carries the same end-to-end integrity check."""
    return _FRAME_HEADER.pack(len(body)) + hashlib.sha256(body).digest() + body


def unframe_bytes(buf: bytes, offset: int = 0) -> tuple[bytes, int]:
    """Inverse of :func:`frame_bytes` starting at ``offset``: returns
    ``(body, next_offset)``. Raises ValueError on a torn (short) or
    corrupted (digest mismatch) frame — callers treat that as "record does
    not exist", never as data."""
    head = offset + _FRAME_HEADER.size
    if len(buf) < head + 32:
        raise ValueError("torn frame: truncated header")
    (length,) = _FRAME_HEADER.unpack_from(buf, offset)
    digest = bytes(buf[head:head + 32])
    end = head + 32 + length
    if len(buf) < end:
        raise ValueError("torn frame: truncated body")
    body = bytes(buf[head + 32:end])
    if hashlib.sha256(body).digest() != digest:
        raise ValueError("corrupt frame: sha256 mismatch")
    return body, end


# ------------------------------------------------------------ cost model
def restore_beats_prefill(tokens: int, bytes_per_token: int,
                          tier_gbps: float,
                          prefill_tokens_per_s: float) -> bool:
    """True when moving ``tokens`` worth of cached KV across a tier
    boundary is cheaper than re-prefilling those tokens — the bytes-vs-FLOPs
    estimate of ``serving.cluster.transfer_beats_prefill`` with the tier's
    bandwidth in place of the wire's. Conservative on unknowns: non-positive
    token counts, bandwidths, or prefill rates never restore (an unknown
    (-1) bandwidth must not flip the inequality by going negative)."""
    if tokens <= 0 or tier_gbps <= 0 or prefill_tokens_per_s <= 0:
        return False
    move_s = tokens * bytes_per_token * 8.0 / (tier_gbps * 1e9)
    return move_s < tokens / prefill_tokens_per_s


def _payload_nbytes(payload: Any) -> int:
    """Total bytes across a payload pytree (numpy arrays or CPU torch
    tensors): walk nested dict/list/tuple containers."""
    if payload is None:
        return 0
    if isinstance(payload, dict):
        return sum(_payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(_payload_nbytes(v) for v in payload)
    return int(getattr(payload, "nbytes", 0))


def _key_digest(key: Any) -> str:
    """Stable filename digest for a hash-chain key. The digest only NAMES
    the record; ``DiskTier.get`` verifies the stored exact key against the
    requested one, so a digest collision degrades to a miss, never a wrong
    splice."""
    return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()[:40]


# ---------------------------------------------------------------- tier 1
class HostTier:
    """Bounded host-RAM arena of demoted KV block payloads, LRU→MRU
    (dict insertion order, same discipline as the allocator's device LRU).
    Not thread-safe on its own — :class:`KVTierStore` serializes access."""

    def __init__(self, budget_blocks: int):
        self.budget_blocks = max(0, int(budget_blocks))
        self._store: dict[Any, Any] = {}   # chain key -> payload, LRU->MRU
        self.nbytes = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return key in self._store

    def get(self, key, touch: bool = True):
        payload = self._store.get(key)
        if payload is not None and touch:
            del self._store[key]
            self._store[key] = payload  # re-insert at the MRU end
        return payload

    def put(self, key, payload) -> list[tuple[Any, Any]]:
        """Insert (or touch) ``key``; returns the LRU entries shed to honor
        the block budget — the caller spills them to the disk tier or drops
        them. A re-inserted key keeps the existing payload (same chain key
        = same KV content for the same model)."""
        if self.budget_blocks <= 0:
            return [(key, payload)]
        if key in self._store:
            existing = self._store.pop(key)
            self._store[key] = existing  # touch to MRU; same key = same KV
            return []
        self._store[key] = payload
        self.nbytes += _payload_nbytes(payload)
        shed: list[tuple[Any, Any]] = []
        while len(self._store) > self.budget_blocks:
            old_key = next(iter(self._store))
            old_payload = self._store.pop(old_key)
            self.nbytes -= _payload_nbytes(old_payload)
            shed.append((old_key, old_payload))
        return shed

    def pop(self, key):
        payload = self._store.pop(key, None)
        if payload is not None:
            self.nbytes -= _payload_nbytes(payload)
        return payload

    def clear(self) -> None:
        self._store.clear()
        self.nbytes = 0


# ---------------------------------------------------------------- tier 2
class DiskTier:
    """Spill directory of demoted KV block records (one file per block).

    Record format: ``RECORD_MAGIC`` + frame(pickled ``{"key": chain_key,
    "codec": codec_id}``) + frame(pickled payload pytree), each frame
    length+sha256 checked — for a quantized payload the second frame covers
    BOTH the low-bit tensors and their scale tensors (they pickle as one
    pytree), and the codec id in the first frame pins which codec wrote
    them: reading a spill under a different codec config raises
    :class:`KVCodecMismatch` instead of silently dequantizing wrong.
    Pre-codec records (a bare pickled chain key) read as codec ``"off"``.
    Writes
    follow the checkpoint commit protocol: same-directory temp file,
    flush+fsync, atomic ``os.replace``, directory fsync — a crash can leave
    a temp file or a torn record, never a half-visible one, and
    :meth:`sweep` clears both classes of debris at engine startup."""

    SUFFIX = ".kvb"

    def __init__(self, directory: str, budget_blocks: int = 0,
                 codec: str = "off"):
        self.directory = str(directory)
        self.budget_blocks = max(0, int(budget_blocks))
        self.codec = str(codec)
        os.makedirs(self.directory, exist_ok=True)
        self.nbytes = 0
        self.sweep_removed = 0
        # digest -> file size, insertion order oldest->newest (budget LRU)
        self._index: dict[str, int] = {}
        self.sweep_removed = self.sweep()
        self._load_index()

    def _path(self, digest: str) -> str:
        return os.path.join(self.directory, digest + self.SUFFIX)

    def sweep(self) -> int:
        """Remove leftover temp files and torn/corrupt records. Returns how
        many files were deleted. Called at construction (= engine startup);
        idempotent and safe to call again."""
        removed = 0
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return 0
        for name in names:
            path = os.path.join(self.directory, name)
            if ".tmp." in name:
                removed += self._unlink(path)
                continue
            if not name.endswith(self.SUFFIX):
                continue
            try:
                with open(path, "rb") as f:
                    buf = f.read()
                if not buf.startswith(RECORD_MAGIC):
                    raise ValueError("bad magic")
                _, off = unframe_bytes(buf, len(RECORD_MAGIC))
                _, end = unframe_bytes(buf, off)
                if end != len(buf):
                    raise ValueError("trailing bytes")
            except (OSError, ValueError):
                removed += self._unlink(path)
        return removed

    @staticmethod
    def _unlink(path: str) -> int:
        try:
            os.unlink(path)
            return 1
        except OSError:
            return 0

    def _load_index(self) -> None:
        """Rebuild the digest index from surviving records (oldest first by
        mtime so the budget LRU keeps working across restarts)."""
        entries = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if not name.endswith(self.SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, name[:-len(self.SUFFIX)], st.st_size))
        for _, digest, size in sorted(entries):
            self._index[digest] = size
            self.nbytes += size

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key) -> bool:
        return _key_digest(key) in self._index

    def put(self, key, payload) -> bool:
        """Atomically persist one demoted block; evicts the oldest records
        past the block budget. False when the budget is 0 (tier disabled)
        or the write failed (spill is best-effort — losing a spill costs a
        re-prefill, never correctness)."""
        if self.budget_blocks <= 0:
            return False
        digest = _key_digest(key)
        if digest in self._index:
            return True  # same chain key = same content: keep the old record
        body = (RECORD_MAGIC
                + frame_bytes(pickle.dumps({"key": key, "codec": self.codec},
                                           protocol=4))
                + frame_bytes(pickle.dumps(payload, protocol=4)))
        path = self._path(digest)
        tmp = os.path.join(self.directory,
                           f".{digest}{self.SUFFIX}.tmp.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._fsync_dir()
        except OSError:
            self._unlink(tmp)
            return False
        self._index[digest] = len(body)
        self.nbytes += len(body)
        while len(self._index) > self.budget_blocks:
            old = next(iter(self._index))
            self.nbytes -= self._index.pop(old)
            self._unlink(self._path(old))
        return True

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass  # platforms without directory fsync

    def get(self, key):
        """Load one record's payload, or None. Every failure mode — missing
        file, torn frame, digest mismatch, or a digest collision where the
        stored exact key differs — reads as a miss, and a corrupt record is
        unlinked so it cannot waste future lookups. The ONE exception is a
        codec mismatch (record written under a different
        ``RaggedConfig.quant``): that RAISES :class:`KVCodecMismatch` — the
        record is intact, the configuration is wrong."""
        digest = _key_digest(key)
        if digest not in self._index:
            return None
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                buf = f.read()
            if not buf.startswith(RECORD_MAGIC):
                raise ValueError("bad magic")
            key_body, off = unframe_bytes(buf, len(RECORD_MAGIC))
            stored = pickle.loads(key_body)
            if isinstance(stored, dict) and "key" in stored:
                stored_key = stored["key"]
                stored_codec = stored.get("codec", "off")
            else:  # pre-codec record: a bare pickled chain key
                stored_key, stored_codec = stored, "off"
            if stored_key != key:
                return None  # digest collision: a miss, never a wrong splice
            if stored_codec != self.codec:
                raise KVCodecMismatch(
                    f"KV spill record {digest} was written under codec "
                    f"{stored_codec!r} but this engine runs {self.codec!r} "
                    "(RaggedConfig.quant); refusing to dequantize — clear "
                    "the tier directory or match the codec config")
            payload_body, _ = unframe_bytes(buf, off)
            return pickle.loads(payload_body)
        except KVCodecMismatch:
            raise
        except (OSError, ValueError, pickle.UnpicklingError, EOFError):
            self.nbytes -= self._index.pop(digest, 0)
            self._unlink(path)
            return None

    def clear(self) -> None:
        for digest in list(self._index):
            self._unlink(self._path(digest))
        self._index.clear()
        self.nbytes = 0


# ------------------------------------------------------------ the store
class _PrefetchJob:
    __slots__ = ("keys", "done", "cancelled")

    def __init__(self, keys: list):
        self.keys = keys
        self.done = threading.Event()
        self.cancelled = False


class KVTierStore:
    """The tier-1/tier-2 half of the hierarchical KV cache, plus the async
    prefetch worker. Thread-safe: the engine thread demotes/promotes, the
    router thread enqueues prefetches, the worker thread stages disk→host —
    every tier mutation happens under one lock (payloads are small compared
    to the device work around them, and the lock is never held across a
    file read in the hot demote path — spill writes happen on whichever
    thread triggered the overflow, which is the engine thread during
    demotion and the worker during staging)."""

    def __init__(self, host_blocks: int, disk_blocks: int = 0,
                 directory: str = "runs/kvtier",
                 host_gbps: float = 100.0, disk_gbps: float = 8.0,
                 prefill_tokens_per_s: float = 50000.0,
                 bytes_per_token: int = 0, codec: str = "off"):
        self.codec = str(codec)
        self.host = HostTier(host_blocks)
        self.disk = DiskTier(directory, disk_blocks, codec=self.codec) \
            if disk_blocks > 0 else None
        self.host_gbps = float(host_gbps)
        self.disk_gbps = float(disk_gbps)
        self.prefill_tokens_per_s = float(prefill_tokens_per_s)
        self.bytes_per_token = int(bytes_per_token)
        self._lock = threading.RLock()
        # cumulative counters (plain ints so the bench reads them with
        # telemetry off; the engine mirrors them into telemetry counters)
        self.demotions = 0            # blocks parked HBM -> host
        self.spills = 0               # blocks shed host -> disk
        self.spill_drops = 0          # host overflow lost (no/full disk tier)
        self.promotions_host = 0      # blocks restored host -> HBM
        self.promotions_disk = 0      # blocks restored disk -> HBM
        self.promoted_admissions_host = 0  # admissions restored from tier 1
        self.promoted_admissions_disk = 0  # ... with at least one tier-2 block
        self.restore_declined = 0     # chain links the cost model refused
        self.prefetch_jobs = 0
        self.prefetch_hits = 0        # admissions whose prefetch finished
        self.prefetch_abandoned = 0   # ... that arrived before it finished
        self.restore_seconds = 0.0    # cumulative engine-side restore time
        self._jobs: dict[Any, _PrefetchJob] = {}
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._closed = False
        # test seam: when set, the worker parks before servicing jobs so the
        # abandoned-prefetch path is deterministically reachable
        self._stall_for_test: threading.Event | None = None

    # ------------------------------------------------------------- queries
    @property
    def promotions(self) -> int:
        return self.promotions_host + self.promotions_disk

    @property
    def sweep_removed(self) -> int:
        return self.disk.sweep_removed if self.disk is not None else 0

    def tier_of(self, key) -> int:
        """1 (host), 2 (disk), or 0 (not in this store)."""
        with self._lock:
            if key in self.host:
                return 1
            if self.disk is not None and key in self.disk:
                return 2
        return 0

    def gbps_of(self, tier: int) -> float:
        return self.host_gbps if tier == 1 else self.disk_gbps

    def should_restore(self, tokens: int, tier: int) -> bool:
        return restore_beats_prefill(tokens, self.bytes_per_token,
                                     self.gbps_of(tier),
                                     self.prefill_tokens_per_s)

    # ------------------------------------------------------------ demotion
    def demote(self, key, payload) -> bool:
        """Park one evicted block's payload in the host arena; LRU overflow
        spills to disk (or is dropped when the disk tier is off/full).
        Called on the engine thread from the allocator's demote hook with
        the payload already gathered to host numpy."""
        with self._lock:
            if self._closed:
                return False
            shed = self.host.put(key, payload)
            self.demotions += 1
            # LRU overflow (or, with a zero host budget, the new block
            # itself) falls through to the disk tier
            for old_key, old_payload in shed:
                if self.disk is not None and self.disk.put(old_key,
                                                           old_payload):
                    self.spills += 1
                else:
                    self.spill_drops += 1
        return True

    # ----------------------------------------------------------- promotion
    def fetch(self, key) -> tuple[Any, int] | None:
        """``(payload, tier)`` for a chain key, host arena first. A disk hit
        returns the payload without staging it into the host arena — the
        caller is about to publish it into HBM, which supersedes both."""
        with self._lock:
            payload = self.host.get(key)
            if payload is not None:
                return payload, 1
            if self.disk is not None:
                payload = self.disk.get(key)
                if payload is not None:
                    return payload, 2
        return None

    def note_restored(self, tiers: list[int], seconds: float) -> None:
        """Engine-side accounting after a successful allocate→scatter→
        publish restore of ``len(tiers)`` blocks."""
        with self._lock:
            n_disk = sum(1 for t in tiers if t == 2)
            self.promotions_disk += n_disk
            self.promotions_host += len(tiers) - n_disk
            if n_disk:
                self.promoted_admissions_disk += 1
            elif tiers:
                self.promoted_admissions_host += 1
            self.restore_seconds += seconds

    # ------------------------------------------------------------ prefetch
    def prefetch(self, keys: list, sig) -> bool:
        """Queue an async staging job for ``keys`` (chain keys missing from
        HBM, chain order): the worker moves matching disk records up into
        the host arena so the admission-time restore only pays the
        host→device hop. Returns False when nothing in this store matches
        (no job, no counters) or a job for ``sig`` is already pending."""
        with self._lock:
            if self._closed or sig in self._jobs:
                return False
            wanted = [k for k in keys if self.tier_of(k) != 0]
            if not wanted:
                return False
            job = _PrefetchJob(wanted)
            self._jobs[sig] = job
            self.prefetch_jobs += 1
            self._ensure_worker()
            self._queue.put(job)
        return True

    def note_admission(self, sig) -> str | None:
        """Resolve the prefetch job for an arriving admission: ``"hit"``
        when staging finished in time, ``"abandoned"`` when the admission
        outran it (the job is cancelled; the synchronous restore path takes
        over — token-identical, only slower), None when no job was queued."""
        with self._lock:
            job = self._jobs.pop(sig, None)
            if job is None:
                return None
            if job.done.is_set():
                self.prefetch_hits += 1
                return "hit"
            job.cancelled = True
            self.prefetch_abandoned += 1
            return "abandoned"

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._queue = queue.Queue()
        self._worker = threading.Thread(
            target=self._run_worker, name="kvtier-prefetch", daemon=True)
        self._worker.start()

    def _run_worker(self) -> None:
        q = self._queue
        while True:
            job = q.get()
            if job is None:
                return
            gate = self._stall_for_test
            if gate is not None:
                gate.wait()
            try:
                self._stage(job)
            except Exception:  # noqa: BLE001 - staging is advisory
                pass
            finally:
                job.done.set()

    def _stage(self, job: _PrefetchJob) -> None:
        for key in job.keys:
            if job.cancelled or self._closed:
                return
            with self._lock:
                if key in self.host or self.disk is None:
                    continue
                payload = self.disk.get(key)
                if payload is None:
                    continue
                # staging must not shed NEWER host entries to make room for
                # an older disk record the admission may not even use: only
                # stage into free host budget
                if len(self.host) < self.host.budget_blocks:
                    self.host.put(key, payload)

    # ---------------------------------------------------------------- misc
    def stats(self) -> dict:
        with self._lock:
            return {
                "host_blocks": len(self.host),
                "host_bytes": int(self.host.nbytes),
                "host_budget_blocks": self.host.budget_blocks,
                "disk_blocks": len(self.disk) if self.disk else 0,
                "disk_bytes": int(self.disk.nbytes) if self.disk else 0,
                "demotions": self.demotions,
                "spills": self.spills,
                "spill_drops": self.spill_drops,
                "promotions": self.promotions,
                "promotions_host": self.promotions_host,
                "promotions_disk": self.promotions_disk,
                "promoted_admissions_host": self.promoted_admissions_host,
                "promoted_admissions_disk": self.promoted_admissions_disk,
                "restore_declined": self.restore_declined,
                "restore_seconds": round(self.restore_seconds, 6),
                "prefetch_jobs": self.prefetch_jobs,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_abandoned": self.prefetch_abandoned,
                "sweep_removed": self.sweep_removed,
                "codec": self.codec,
            }

    @property
    def host_nbytes(self) -> int:
        return int(self.host.nbytes)

    @property
    def disk_nbytes(self) -> int:
        return int(self.disk.nbytes) if self.disk is not None else 0

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until every queued prefetch job finished (tests/ops)."""
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                jobs = [j for j in self._jobs.values()]
            pending = [j for j in jobs if not j.done.is_set()]
            if not pending:
                return True
            if time.perf_counter() >= deadline:
                return False
            pending[0].done.wait(min(0.05, timeout))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for job in self._jobs.values():
                job.cancelled = True
            self._jobs.clear()
            if self._queue is not None:
                self._queue.put(None)
