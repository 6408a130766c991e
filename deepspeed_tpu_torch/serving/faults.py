"""Deterministic fault injection (counterpart of
``deepspeed_tpu/serving/faults.py``: the same points, kinds and schedule
semantics).

A process-local :class:`FaultInjector` singleton exposes **named injection
points** at the real seams of the serving stack — device dispatch, H2D
upload, token readback, block allocation, the engine-loop iteration and the
router -> replica submit edge. Production code calls ``fire(point)`` at each
seam; with no faults armed this is a single attribute check and the hot
paths pay nothing. Tests and ``chip_smoke.py`` arm a *schedule* of
:class:`FaultSpec` entries, each of which fires deterministically by hit
count (``after`` / ``every`` / ``times``) or per request (``request_id``),
so a failing run replays exactly. The ragged engine fires every point on
the host, before the program it guards is launched or replayed, never
inside a captured CUDA graph.

The training engine fires the checkpoint points (``checkpoint/``,
``Engine.save_checkpoint`` / ``load_checkpoint``) and the training points
(``Engine.train_batch``: ``train.grads`` and ``data.batch`` before the
step, whose directives multiply the loss, and ``train.dispatch`` after it).
The pipeline point is carried as a name only (ROADMAP.md queue 1 item 12).

Fault kinds: ``raise`` (:class:`FaultError`, or :class:`FatalFaultError`
with ``fatal=True``), ``hang`` (sleep ``delay_s`` then ``TimeoutError``),
``latency`` and ``wedge`` (sleep and continue), ``truncate`` and
``corrupt-bytes`` (mutate the file the seam passed as ``path``), ``kill``
(``SIGKILL`` the process), ``oom`` (a :class:`FaultError` worded like an
allocator failure), and the directive kinds ``nan-grads`` / ``loss-spike`` /
``poison-batch``, which ``fire()`` returns to the seam.

``classify_transient`` is the error taxonomy the dispatch watchdog
(``inference/ragged.py``) and the router breaker share, mapped onto torch:
injected transient faults, ``TimeoutError`` and connection errors retry;
``torch.cuda.OutOfMemoryError`` and the injected ``oom`` kind are the OOM
hint (``is_resource_exhausted``), which the watchdog retries on a lower rung;
every other CUDA error is fatal — a sticky CUDA error poisons the context,
so retrying on the same card would be wrong.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field

import torch

from deepspeed_tpu_torch.telemetry import get_telemetry

# Named injection points (the real seams).
POINT_DISPATCH = "engine.dispatch"   # jitted step/chunk/fused program launch
POINT_H2D = "engine.h2d"             # host→device staging upload
POINT_READBACK = "engine.readback"   # device→host token/logits readback
POINT_ALLOC = "engine.alloc"         # KV block allocation
POINT_LOOP = "loop.step"             # engine-loop thread, once per busy tick
POINT_SUBMIT = "router.submit"       # router→replica submit edge

# Training checkpoint seams. The file-mutating kinds (truncate /
# corrupt-bytes) act on the path each seam passes via ``fire(path=)``.
POINT_CKPT_COLLECT = "ckpt.collect"  # device→host shard snapshot
POINT_CKPT_FLUSH = "ckpt.flush"      # fragment/index writes into staging
POINT_CKPT_COMMIT = "ckpt.commit"    # manifest sealed, before dir promote
POINT_CKPT_LATEST = "ckpt.latest"    # latest-pointer update
POINT_CKPT_LOAD = "ckpt.load"        # load/verify entry

# Training-step seams (``pipe.stage``: named only, item 12).
POINT_TRAIN_DISPATCH = "train.dispatch"  # fused train step launch/fence
POINT_TRAIN_GRADS = "train.grads"        # grad computation (transient anomaly)
POINT_DATA_BATCH = "data.batch"          # batch admission (content-keyed)
POINT_PIPE_STAGE = "pipe.stage"          # MPMD stage thread, per instruction

POINTS = (
    POINT_DISPATCH,
    POINT_H2D,
    POINT_READBACK,
    POINT_ALLOC,
    POINT_LOOP,
    POINT_SUBMIT,
    POINT_CKPT_COLLECT,
    POINT_CKPT_FLUSH,
    POINT_CKPT_COMMIT,
    POINT_CKPT_LATEST,
    POINT_CKPT_LOAD,
    POINT_TRAIN_DISPATCH,
    POINT_TRAIN_GRADS,
    POINT_DATA_BATCH,
    POINT_PIPE_STAGE,
)

# Kinds whose firing returns the kind string to the seam (which applies the
# perturbation itself) instead of raising/sleeping here.
DIRECTIVE_KINDS = ("nan-grads", "loss-spike", "poison-batch")


class FaultError(RuntimeError):
    """An injected failure. ``transient`` mirrors the real-world class the
    injection models (a retryable transfer/dispatch error)."""

    transient = True

    def __init__(self, message: str, point: str = ""):
        super().__init__(message)
        self.point = point


class FatalFaultError(FaultError):
    """An injected non-retryable failure (poisoned state, bad program)."""

    transient = False


@dataclass
class FaultSpec:
    """One armed fault. Firing is counted per spec: the spec matches the
    ``hits``-th eligible call when ``hits > after``, ``(hits - after - 1)``
    is a multiple of ``every``, and fewer than ``times`` firings have
    happened (``times=0`` = unlimited)."""

    point: str
    kind: str = "raise"              # raise | hang | latency
    after: int = 0                   # skip this many eligible hits first
    times: int = 1                   # max firings (0 = unlimited)
    every: int = 1                   # then fire every N-th eligible hit
    request_id: str | None = None    # only hits carrying this request id
    delay_s: float = 0.05            # hang/latency sleep
    fatal: bool = False              # raise FatalFaultError instead
    probability: float = 1.0         # eligible-hit firing probability
    message: str = ""
    hits: int = field(default=0, init=False)
    fired: int = field(default=0, init=False)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} (known: {POINTS})")
        if self.kind not in ("raise", "hang", "latency", "truncate",
                             "corrupt-bytes", "kill", "oom", "wedge",
                             *DIRECTIVE_KINDS):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Deterministic, seedable fault scheduler (module singleton below).

    Off by default: ``fire()`` returns immediately unless ``enabled``.
    Thread-safe — the engine loop, HTTP handler threads, and the router
    all fire through the one instance.
    """

    def __init__(self):
        self.enabled = False
        self._specs: list[FaultSpec] = []
        self._rng = random.Random(0)
        self._fired: dict[str, int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- arming
    def configure(self, specs, seed: int = 0) -> "FaultInjector":
        """Arm a schedule: a list of :class:`FaultSpec` or plain dicts
        (JSON-loadable)."""
        with self._lock:
            self._specs = [
                s if isinstance(s, FaultSpec) else FaultSpec(**s)
                for s in (specs or [])
            ]
            self._rng = random.Random(seed)
            self._fired = {}
            self.enabled = bool(self._specs)
        return self

    def arm(self, point: str, **kw) -> FaultSpec:
        """Arm one additional fault at ``point``."""
        spec = FaultSpec(point=point, **kw)
        with self._lock:
            self._specs.append(spec)
            self.enabled = True
        return spec

    def reset(self) -> None:
        """Disarm everything (test isolation)."""
        with self._lock:
            self._specs = []
            self._fired = {}
            self._rng = random.Random(0)
            self.enabled = False

    # ------------------------------------------------------------- firing
    def fire(self, point: str, request_id: str | None = None,
             path: str | None = None) -> str | None:
        """Called by production code at the named seam. No-op unless a
        matching armed spec elects this hit. ``path`` names the file the
        seam just touched, for the file-mutating kinds. Directive kinds
        (``nan-grads`` / ``loss-spike`` / ``poison-batch``) return the kind
        string so the seam applies the perturbation; every other kind
        returns ``None`` (callers that ignore the return are unaffected)."""
        if not self.enabled:
            return None
        spec = None
        with self._lock:
            for s in self._specs:
                if s.point != point:
                    continue
                if s.request_id is not None and s.request_id != request_id:
                    continue
                if s.kind in ("truncate", "corrupt-bytes") and path is None:
                    continue  # file kinds only elect hits that carry a path
                s.hits += 1
                if s.times and s.fired >= s.times:
                    continue
                n = s.hits - s.after
                if n <= 0 or (n - 1) % max(1, s.every):
                    continue
                if s.probability < 1.0 and self._rng.random() >= s.probability:
                    continue
                s.fired += 1
                self._fired[point] = self._fired.get(point, 0) + 1
                spec = s
                break
        if spec is None:
            return None
        tel = get_telemetry()
        if tel.enabled:
            tel.counter(
                "fault_injected_total",
                "injected faults fired, by point").inc(point=point,
                                                       kind=spec.kind)
        msg = spec.message or (
            f"injected {spec.kind} fault at {point}"
            f" (hit {spec.hits}, firing {spec.fired})")
        if spec.kind in DIRECTIVE_KINDS:
            return spec.kind
        if spec.kind == "latency":
            time.sleep(spec.delay_s)
            return None
        if spec.kind == "wedge":
            # a stuck dispatch: the seam simply stops making progress — no
            # error to catch, only a stale heartbeat / watchdog deadline
            time.sleep(spec.delay_s)
            return None
        if spec.kind == "kill":
            # a preemption landing exactly at this seam: no cleanup, no
            # flush, no atexit — the process is simply gone
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)  # pragma: no cover - death is asynchronous
            return
        if spec.kind == "truncate":
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
            return
        if spec.kind == "corrupt-bytes":
            size = os.path.getsize(path)
            if size:
                with self._lock:
                    off = self._rng.randrange(size)
                with open(path, "r+b") as f:
                    f.seek(off)
                    orig = f.read(1)
                    f.seek(off)
                    f.write(bytes([(orig[0] ^ 0xFF) if orig else 0xFF]))
            return
        if spec.kind == "hang":
            time.sleep(spec.delay_s)
            raise TimeoutError(msg)
        if spec.kind == "oom":
            # worded like an allocator failure so is_resource_exhausted and
            # the watchdog's degradation hint treat it exactly like one
            raise FaultError(
                spec.message or (
                    f"RESOURCE_EXHAUSTED: injected out-of-memory at {point} "
                    f"(hit {spec.hits}, firing {spec.fired})"), point)
        if spec.fatal:
            raise FatalFaultError(msg, point)
        raise FaultError(msg, point)

    # ------------------------------------------------------------- introspect
    def counts(self) -> dict:
        """``{point: firings}`` so far (bench/CI assertions)."""
        with self._lock:
            return dict(self._fired)

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())


_INJECTOR = FaultInjector()


def get_fault_injector() -> FaultInjector:
    """The process-local injector shared by every seam."""
    return _INJECTOR


# Substrings in runtime error text that indicate a retryable condition.
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "TRANSFER",
    "SOCKET CLOSED",
    "CONNECTION RESET",
    "TEMPORARILY",
)

# Substrings of CUDA runtime and library errors (torch raises them as
# RuntimeError, or torch.AcceleratorError where it has one)
_CUDA_MARKERS = ("CUDA ERROR", "CUDA-CAPABLE", "CUBLAS_STATUS", "CUDNN_STATUS",
                 "CUDA DRIVER", "CUDA KERNEL", "CUDAERROR", "DEVICE-SIDE ASSERT")


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether ``exc`` is an out-of-memory failure: torch's
    ``OutOfMemoryError`` (the caching allocator could not fund an
    allocation; not sticky) or an injected ``oom`` fault."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return "RESOURCE_EXHAUSTED" in str(exc)


def is_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA runtime or library error (other than the
    allocator's out-of-memory)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    msg = str(exc).upper()
    return any(marker in msg for marker in _CUDA_MARKERS)


def classify_transient(exc: BaseException) -> bool:
    """Shared transient-vs-fatal taxonomy for the dispatch watchdog and the
    replica breaker. Transient errors are retried with backoff; fatal ones
    escalate (degradation / crash containment / quarantine). A CUDA error
    is fatal: it may have poisoned the context."""
    if isinstance(exc, FaultError):
        return exc.transient
    if is_cuda_error(exc) or isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError, BrokenPipeError)):
        return True
    if isinstance(exc, OSError):
        return True
    msg = str(exc).upper()
    return any(marker in msg for marker in _TRANSIENT_MARKERS)
