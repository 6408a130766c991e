"""Per-replica step-loop driver: the thread that owns a RaggedInferenceEngine
(counterpart of ``deepspeed_tpu/serving/engine_loop.py``).

The ragged engine (``inference/ragged.py``) is a pull-driven scheduler —
someone must pump ``put()``/``step()`` — and it is not thread-safe. The
``EngineLoop`` makes it servable: one background thread owns the engine
outright, requests arrive through a bounded priority inbox, emitted tokens
are delivered to per-request ``TokenStream`` queues as each step completes,
and graceful drain (stop admitting, finish inflight, exit) is a flag flip,
safe to call from a SIGTERM handler.

The engine runs on the loop thread: its programs run on the engine's own
device and stream, whatever the thread's current ones are
(``RaggedInferenceEngine.step``). Call its ``warmup()`` before ``start()``,
so no CUDA graph is captured while request threads run.

Cross-thread surface, by design minimal:

- ``submit()``/``cancel()`` mutate only the inbox under its lock and set a
  wake event; the loop thread does every ``engine.*`` call.
- ``stats()`` combines the loop thread's last published engine snapshot
  (an immutable tuple swap — no lock on the hot path) with the live inbox
  counters, giving the router a conservative view for placement/admission.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from dataclasses import dataclass

from deepspeed_tpu_torch.serving.faults import POINT_LOOP, get_fault_injector
from deepspeed_tpu_torch.serving.protocol import (
    FINISH_CANCELLED,
    FINISH_LENGTH,
    FINISH_STOP,
    CompletionRequest,
)
from deepspeed_tpu_torch.telemetry import get_telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


class StreamError(RuntimeError):
    """The request failed server-side (validation or engine error)."""


class ReplicaDraining(RuntimeError):
    """submit() after begin_drain(): the replica no longer admits work."""


class TokenStream:
    """Consumer handle for one request's token stream.

    The loop thread pushes ``("token", id)`` events and exactly one terminal
    ``("done", finish_reason)`` or ``("error", message)``; consumers iterate
    ``events()`` (SSE path) or block on ``collect()`` (non-streaming path).
    """

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.finish_reason: str | None = None
        self.error: str | None = None
        # structured failure detail: an HTTP-equivalent status and a
        # machine-readable reason ("replica_died", "engine_crash",
        # "deadline", ...) so the frontend can map the error to the right
        # response and the router can decide whether failover is sound
        self.error_code: int | None = None
        self.error_reason: str | None = None
        self._q: queue.SimpleQueue = queue.SimpleQueue()

    # ---------------------------------------------- producer (loop thread)
    def _push(self, token: int) -> None:
        self._q.put(("token", int(token)))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._q.put(("done", reason))

    def _fail(self, message: str, code: int | None = None,
              reason: str | None = None) -> None:
        self.error = message
        self.error_code = code
        self.error_reason = reason
        self._q.put(("error", message))

    # ---------------------------------------------------------- consumer
    def events(self, timeout: float | None = None):
        """Yield ``("token", id)`` events until the terminal ``("done", _)``
        / ``("error", _)`` event, which is yielded last. ``timeout`` bounds
        the wait for EACH event (TimeoutError past it)."""
        while True:
            try:
                kind, value = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.request_id}: no event within {timeout}s"
                ) from None
            yield kind, value
            if kind in ("done", "error"):
                return

    def collect(self, timeout: float | None = None) -> tuple[list[int], str]:
        """Block until terminal; returns ``(tokens, finish_reason)`` or
        raises StreamError / TimeoutError."""
        tokens: list[int] = []
        for kind, value in self.events(timeout=timeout):
            if kind == "token":
                tokens.append(value)
            elif kind == "error":
                raise StreamError(value)
            else:
                return tokens, value
        raise StreamError(f"request {self.request_id}: stream ended abruptly")


@dataclass(frozen=True)
class ReplicaStats:
    """Router-facing snapshot of one replica (conservative: inbox work not
    yet visible to the engine counts as queued/pending)."""

    name: str
    alive: bool
    draining: bool
    queued: int               # engine queue + undrained inbox
    inflight: int             # admitted (running) sequences
    outstanding_tokens: int   # remaining prompt+decode tokens across all work
    free_blocks: int          # unreserved free KV blocks in the engine pool
    pending_blocks: int       # worst-case blocks promised to inbox requests
    block_size: int
    usable_blocks: int        # pool size minus the scratch block
    max_request_blocks: int   # per-request block ceiling (put() rejects past it)
    max_request_tokens: int   # engine max_seq_len
    degraded: int = 0         # engine degraded_mode rung (0 = full path)
    crashes: int = 0          # step exceptions contained by the loop
    respawns: int = 0         # loop-thread deaths survived by respawn
    # disaggregated serving: "prefill" replicas only run prompt stages
    # (handoff exports), "decode" replicas adopt handoffs; "unified" does
    # everything. plan_placement() filters on this.
    role: str = "unified"
    # multi-step scheduled decode: dispatches per emitted token (1.0 for a
    # per-token engine; the device-side scheduler drives it toward 1/K) and
    # the self-speculation draft economy, for cluster-level observability
    dispatches_per_token: float = 1.0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # measured free-byte headroom expressed in KV blocks (-1: not measured;
    # headroom admission is ROADMAP.md queue 1 item 14, so the port's
    # engine always reports -1 and routers use the static block math)
    headroom_blocks: int = -1

    def worst_blocks(self, total_tokens: int) -> int:
        return -(-total_tokens // self.block_size)


class _Open:
    """Loop-thread bookkeeping for one in-engine request."""

    __slots__ = ("stream", "delivered")

    def __init__(self, stream: TokenStream):
        self.stream = stream
        self.delivered = 0


class EngineLoop:
    """Background driver for one RaggedInferenceEngine replica."""

    def __init__(self, engine, name: str = "replica-0",
                 idle_wait_s: float = 0.002, max_respawns: int = 3,
                 role: str = "unified"):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self._engine = engine
        self.name = name
        self.role = role
        self._idle_wait_s = float(idle_wait_s)
        self._max_respawns = int(max_respawns)
        self._faults = get_fault_injector()
        # fault-tolerance counters: crash_count = step exceptions contained
        # in-place (affected requests failed, engine state rebuilt, loop
        # keeps running); respawn_count = loop-thread deaths survived by
        # starting a replacement thread
        self.crash_count = 0
        self.respawn_count = 0
        # monotonically increasing count of successful engine steps
        self.steps = 0
        self._consec_crashes = 0
        self._lock = threading.Lock()
        self._inbox: list = []       # heap of (priority, seqno, req, stream)
        self._seqno = itertools.count()
        self._cancel_ids: set[str] = set()
        self._pending_blocks = 0
        self._pending_tokens = 0
        self._open: dict[str, _Open] = {}
        # cross-thread engine calls (cluster KV export/import): the loop
        # thread runs each entry's first element against the engine; the
        # second is the drop handler invoked if the loop dies first
        self._pending_calls: list = []
        self._wake = threading.Event()
        self._draining = threading.Event()
        self._stopped = threading.Event()
        # alive = "has not died": true from construction so a cold (not yet
        # started) loop can accumulate queued work, false once _run exits
        self._alive = True
        self.error: str | None = None
        self._thread = threading.Thread(
            target=self._run, name=f"engine-loop-{name}", daemon=True)
        cfg = engine.cfg
        self._block_size = cfg.block_size
        self._usable_blocks = cfg.num_blocks - 1
        self._max_request_blocks = min(cfg.num_blocks - 1,
                                       cfg.max_blocks_per_seq)
        self._max_request_tokens = cfg.max_seq_len
        # (queued, inflight, outstanding_tokens, free_unreserved_blocks):
        # published by the loop thread as an atomic tuple swap
        self._engine_stats = (0, 0, 0, engine.allocator.free_blocks)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EngineLoop":
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop admitting; the loop finishes inflight work then exits.
        Non-blocking and signal-safe (flag flips only)."""
        self._draining.set()
        self._wake.set()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the loop to exit (after ``begin_drain``). Waits on the
        ``_stopped`` event, not the thread handle: a respawn swaps
        ``self._thread`` for a replacement, and only final death (or clean
        drain) sets ``_stopped``."""
        if self._stopped.is_set():
            return True
        if self._thread.ident is None:  # never started: nothing will run
            return True
        return self._stopped.wait(timeout)

    def close(self, timeout: float | None = 30.0) -> bool:
        self.begin_drain()
        return self.join(timeout)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # -------------------------------------------------------------- submit
    def _worst_blocks(self, req: CompletionRequest) -> int:
        return -(-req.total_tokens // self._block_size)

    def submit(self, req: CompletionRequest) -> TokenStream:
        """Enqueue a request; returns its TokenStream immediately. The
        actual ``engine.put()`` happens on the loop thread (priority order,
        lower first). Raises ReplicaDraining after ``begin_drain``."""
        if self._draining.is_set():
            raise ReplicaDraining(f"{self.name} is draining")
        if not req.t_submit:
            # stamp here (not only in the frontend) so deadline-aware inbox
            # shedding measures queue wait for direct submitters too
            req.t_submit = time.perf_counter()
        stream = TokenStream(req.request_id)
        with self._lock:
            heapq.heappush(
                self._inbox, (req.priority, next(self._seqno), req, stream))
            self._pending_blocks += self._worst_blocks(req)
            self._pending_tokens += req.total_tokens
        self._wake.set()
        return stream

    def cancel(self, request_id: str) -> None:
        """Abort a request wherever it is (inbox, queued, or running); its
        stream terminates with finish_reason=cancelled and KV blocks free on
        the loop's next step."""
        with self._lock:
            self._cancel_ids.add(request_id)
        self._wake.set()

    def cached_prefix_tokens(self, prompt_tokens) -> int:
        """Tokens of ``prompt_tokens`` the engine's prefix cache could serve
        right now. An ADVISORY cross-thread probe: it reads the engine's
        prefix index without locking (dict reads are atomic in CPython, and
        the router only uses the answer to bias placement/admission — a
        stale answer costs one conservative decision, never correctness).
        Engines without a prefix cache (or with it disabled) report 0."""
        probe = getattr(self._engine, "cached_prefix_len", None)
        if probe is None:
            return 0
        try:
            return int(probe(prompt_tokens))
        except Exception:  # noqa: BLE001 - advisory: racing a mutation is fine
            return 0

    def prefetch_prefix(self, prompt_tokens) -> None:
        """Advisory tier-prefetch kick: ask the engine's KV tier store to
        stage any demoted blocks of ``prompt_tokens`` disk→host while the
        request waits in the queue. Fire-and-forget from the router thread —
        the method is thread-safe on the engine side (it only touches the
        tier store's own lock plus racy-safe dict probes), and a missed or
        stale prefetch costs latency, never correctness."""
        kick = getattr(self._engine, "tier_prefetch_async", None)
        if kick is None:
            return
        try:
            kick(prompt_tokens)
        except Exception:  # noqa: BLE001 - advisory: never fail a submit
            pass

    def kv_tier_stats(self):
        """Tier-store counters/bytes for this replica, or None when tiering
        is off. Advisory cross-thread read (plain ints + dict builds)."""
        probe = getattr(self._engine, "kv_tier_stats", None)
        if probe is None:
            return None
        try:
            return probe()
        except Exception:  # noqa: BLE001 - advisory
            return None

    # --------------------------------- cross-thread engine calls (cluster)
    def call(self, fn, timeout: float | None = 30.0):
        """Run ``fn(engine)`` on the loop thread and return its result.

        The engine is single-owner (the loop thread does every ``engine.*``
        call), so the cluster's KV handoff/prefix transfers go through here
        instead of touching the engine directly. On a loop whose thread was
        never started the call runs inline (the caller is the only owner —
        the unit-test convenience). Raises ``fn``'s exception, TimeoutError
        past ``timeout``, or RuntimeError if the loop dies/exits before
        servicing the call."""
        if self._stopped.is_set():
            raise RuntimeError(f"{self.name}: loop is stopped")
        if self._thread.ident is None:
            return fn(self._engine)
        box: dict = {}
        done = threading.Event()

        def run(eng):
            try:
                box["value"] = fn(eng)
            except BaseException as e:  # noqa: BLE001 - re-raised at caller
                box["exc"] = e
            finally:
                done.set()

        def drop(msg: str):
            box["exc"] = RuntimeError(msg)
            done.set()

        with self._lock:
            self._pending_calls.append((run, drop))
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError(
                f"{self.name}: engine call not serviced within {timeout}s")
        if "exc" in box:
            raise box["exc"]
        return box.get("value")

    def adopt(self, req: CompletionRequest, handoff) -> TokenStream:
        """Adopt a prefill replica's handoff record as a live request.

        The loop thread imports the KV payload (``engine.import_handoff``);
        the returned stream then carries the WHOLE generation — the prefill
        stage's first token included, since delivery starts at generated
        index 0 and the record's ``generated`` seeds it. On rejection (no
        slot/blocks right now, or a record this engine can never fit) the
        stream fails with ``reason="import_rejected"`` so the cluster can
        fall back to a cold submit."""
        if self._draining.is_set():
            raise ReplicaDraining(f"{self.name} is draining")
        stream = TokenStream(req.request_id)
        rid = req.request_id

        def _do(eng):
            if self._draining.is_set():
                stream._fail(f"{self.name} is draining", code=503,
                             reason="import_rejected")
                return
            try:
                ok = eng.import_handoff(handoff)
            except Exception as e:  # noqa: BLE001 - structurally unservable
                stream._fail(f"handoff import failed on {self.name}: {e}",
                             code=503, reason="import_rejected")
                return
            if not ok:
                stream._fail(
                    f"{self.name}: no slot/blocks to adopt handoff {rid}",
                    code=503, reason="import_rejected")
                return
            self._open[rid] = _Open(stream)

        def drop(msg: str):
            stream._fail(msg, code=503, reason="replica_died")

        if self._stopped.is_set():
            drop(f"{self.name}: loop is stopped")
            return stream
        if self._thread.ident is None:
            _do(self._engine)
            return stream
        with self._lock:
            self._pending_calls.append((_do, drop))
        self._wake.set()
        return stream

    # --------------------------------------------------------------- stats
    def stats(self) -> ReplicaStats:
        queued, inflight, outstanding, free = self._engine_stats
        with self._lock:
            n_inbox = len(self._inbox)
            pending_blocks = self._pending_blocks
            pending_tokens = self._pending_tokens
        return ReplicaStats(
            name=self.name, alive=self._alive,
            draining=self._draining.is_set(),
            queued=queued + n_inbox, inflight=inflight,
            outstanding_tokens=outstanding + pending_tokens,
            free_blocks=free, pending_blocks=pending_blocks,
            block_size=self._block_size, usable_blocks=self._usable_blocks,
            max_request_blocks=self._max_request_blocks,
            max_request_tokens=self._max_request_tokens,
            degraded=int(getattr(self._engine, "degraded_mode", 0)),
            crashes=self.crash_count, respawns=self.respawn_count,
            role=self.role,
            dispatches_per_token=(
                getattr(self._engine, "dispatch_count", 0)
                / max(getattr(self._engine, "tokens_emitted", 0), 1)),
            spec_proposed=int(getattr(self._engine, "spec_proposed", 0)),
            spec_accepted=int(getattr(self._engine, "spec_accepted", 0)),
            headroom_blocks=int(getattr(
                self._engine, "admission_headroom_blocks", lambda: -1)()))

    # ------------------------------------------------------- loop internals
    def _drain_inbox(self) -> None:
        eng = self._engine
        with self._lock:
            items = [heapq.heappop(self._inbox) for _ in range(len(self._inbox))]
            cancels = self._cancel_ids
            self._cancel_ids = set()
        for _, _, req, stream in items:
            rid = req.request_id
            if rid in cancels:
                cancels.discard(rid)
                stream._finish(FINISH_CANCELLED)
            elif (req.deadline_s is not None and req.t_submit
                  and time.perf_counter() - req.t_submit >= req.deadline_s):
                # deadline already burned in the inbox: shed instead of
                # dispatching doomed work (504-equivalent structured error)
                stream._fail(
                    f"request {rid}: deadline_s={req.deadline_s} expired "
                    f"before placement on {self.name}",
                    code=504, reason="deadline")
                tel = get_telemetry()
                if tel.enabled:
                    tel.counter(
                        "serving_requests_shed_total",
                        "expired-deadline requests shed pre-placement",
                    ).inc(replica=self.name)
            else:
                if req.trace_ctx is not None and req.t_submit:
                    # frontend submit → loop-thread pickup: the cross-thread
                    # inbox wait, recorded retroactively from the stamp
                    get_telemetry().tracer.record(
                        req.trace_ctx, "loop/inbox_wait", req.t_submit,
                        time.perf_counter(), replica=self.name,
                        priority=req.priority)
                try:
                    eng.put(rid, req.prompt, max_new_tokens=req.max_tokens,
                            eos_token_id=req.eos_token_id,
                            temperature=req.temperature, top_k=req.top_k,
                            top_p=req.top_p, deadline_s=req.deadline_s,
                            seed=req.seed, trace=req.trace_ctx,
                            handoff=getattr(req, "handoff", False),
                            expected_cached_tokens=getattr(
                                req, "cached_tokens_hint", 0),
                            tenant=getattr(req, "tenant", "default"),
                            sla_class=getattr(
                                req, "sla_class", "interactive"))
                    self._open[rid] = _Open(stream)
                except ValueError as e:
                    stream._fail(str(e))
            with self._lock:
                self._pending_blocks -= self._worst_blocks(req)
                self._pending_tokens -= req.total_tokens
        for rid in cancels:
            eng.cancel(rid)  # unknown/already-retired ids are a no-op

    def _finish_reason(self, seq) -> str:
        if seq.status != "finished":
            return seq.status  # cancelled | timeout
        if (seq.eos_token_id is not None and seq.generated
                and seq.generated[-1] == seq.eos_token_id):
            return FINISH_STOP
        return FINISH_LENGTH

    def _deliver(self) -> None:
        eng = self._engine
        for rid in list(self._open):
            op = self._open[rid]
            seq = eng.get_request(rid)
            if seq is None:  # pragma: no cover - put() succeeded, must exist
                op.stream._fail(f"request {rid} lost by engine")
                del self._open[rid]
                continue
            gen = seq.generated
            while op.delivered < len(gen):
                op.stream._push(gen[op.delivered])
                op.delivered += 1
            if rid in eng._results:
                op.stream._finish(self._finish_reason(seq))
                del self._open[rid]

    def _publish_stats(self) -> None:
        eng = self._engine
        outstanding = 0
        for s in eng._queued:
            outstanding += len(s.prompt) + s.max_new_tokens
        for s in eng._running.values():
            # Under async readback (device-resident dispatch, fused pipeline)
            # s.pos runs ahead of len(s.generated) by the in-flight window;
            # tokens already scheduled on device are progress, not load the
            # admission controller should throttle on.
            progress = max(len(s.generated), s.pos - len(s.prompt))
            outstanding += max(0, len(s.prompt) - s.pos) + \
                max(0, s.max_new_tokens - progress)
        self._engine_stats = (
            len(eng._queued), len(eng._running), outstanding,
            eng.allocator.free_blocks - eng._reserved)
        tel = get_telemetry()
        if tel.enabled:
            # per-priority inbox depth: the default
            # priority-0 row always publishes (so an empty inbox scrapes as
            # an explicit 0, not an absent series), other priorities appear
            # on first use and are zeroed — not left frozen — when they
            # empty out
            with self._lock:
                depths: dict[int, int] = {}
                for prio, _, _, _ in self._inbox:
                    depths[prio] = depths.get(prio, 0) + 1
            last = getattr(self, "_last_inbox_depths", None)
            g = tel.gauge("serving_inbox_depth",
                          "requests waiting in the loop inbox, "
                          "by priority")
            for prio in (set(depths) | set(last or ()) | {0}):
                g.set(depths.get(prio, 0),
                      replica=self.name, priority=str(prio))
            self._last_inbox_depths = depths

    def _contain(self, exc: Exception) -> None:
        """Crash containment for one failed ``engine.step()``: fail only the
        affected requests with a structured error, rebuild the poisoned
        engine state, and keep the loop running. Repeated back-to-back
        crashes escalate to loop death (handled by ``_run``'s respawn)."""
        self.crash_count += 1
        self._consec_crashes += 1
        if self._consec_crashes > self._max_respawns:
            raise exc  # containment is not converging — escalate
        msg = (f"engine step crashed on {self.name}: "
               f"{type(exc).__name__}: {exc}")
        log_dist(f"{msg} (contained; rebuilding engine state)", ranks=[0])
        tel = get_telemetry()
        if tel.enabled:
            tel.counter(
                "engine_loop_crashes_total",
                "engine.step() exceptions contained by the loop",
            ).inc(replica=self.name)
        try:
            self._deliver()  # flush tokens/finishes that predate the crash
        except Exception:  # noqa: BLE001 - engine state may be poisoned
            pass
        for op in self._open.values():
            op.stream._fail(msg, code=500, reason="engine_crash")
        self._open.clear()
        self._engine.reset_state()
        self._publish_stats()

    def _drain_calls(self) -> None:
        with self._lock:
            calls, self._pending_calls = self._pending_calls, []
        for run, _ in calls:
            run(self._engine)  # run() boxes fn's exceptions for the caller

    def _drop_calls(self, msg: str) -> None:
        with self._lock:
            calls, self._pending_calls = self._pending_calls, []
        for _, drop in calls:
            drop(msg)

    def _run_loop(self) -> None:
        eng = self._engine
        while True:
            self._drain_inbox()
            self._drain_calls()
            if eng.has_work:
                if self._faults.enabled:
                    # outside the try: an injected loop fault kills the
                    # thread (exercising respawn), engine faults exercise
                    # containment. Idle replicas never reach this point,
                    # which keeps chaos schedules deterministic.
                    self._faults.fire(POINT_LOOP)
                try:
                    eng.step()
                except Exception as e:  # noqa: BLE001 - contain, don't die
                    self._contain(e)
                else:
                    self._consec_crashes = 0
                    self.steps += 1
                self._deliver()
                self._publish_stats()
                continue
            self._deliver()
            self._publish_stats()
            with self._lock:
                idle = (not self._inbox and not self._cancel_ids
                        and not self._pending_calls)
            if idle and self._draining.is_set():
                return
            self._wake.wait(self._idle_wait_s)
            self._wake.clear()

    def _fail_all(self, msg: str, code: int, reason: str) -> None:
        for op in self._open.values():
            op.stream._fail(msg, code=code, reason=reason)
        self._open.clear()
        with self._lock:
            items, self._inbox = self._inbox, []
            self._pending_blocks = self._pending_tokens = 0
        for _, _, _, stream in items:
            stream._fail(msg, code=code, reason=reason)
        self._drop_calls(msg)

    def _run(self) -> None:
        try:
            self._run_loop()
        except Exception as e:  # noqa: BLE001 - the loop IS the failure domain
            self.error = f"{type(e).__name__}: {e}"
            log_dist(f"engine loop {self.name} died: {self.error}", ranks=[0])
            self._fail_all(self.error, code=503, reason="replica_died")
            if (not self._draining.is_set()
                    and self.respawn_count < self._max_respawns):
                # respawn rather than silently dying: rebuild the engine,
                # start a replacement thread, and leave _alive/_stopped
                # untouched so the replica stays routable
                try:
                    self._engine.reset_state()
                except Exception as re:  # noqa: BLE001 - rebuild failed
                    log_dist(f"engine loop {self.name}: state rebuild after "
                             f"death failed ({re}); staying down", ranks=[0])
                else:
                    self.respawn_count += 1
                    self._consec_crashes = 0
                    tel = get_telemetry()
                    if tel.enabled:
                        tel.counter(
                            "engine_loop_respawns_total",
                            "engine-loop threads respawned after death",
                        ).inc(replica=self.name)
                    log_dist(f"engine loop {self.name}: respawning thread "
                             f"({self.respawn_count}/{self._max_respawns})",
                             ranks=[0])
                    self._thread = threading.Thread(
                        target=self._run,
                        name=f"engine-loop-{self.name}-r{self.respawn_count}",
                        daemon=True)
                    self._thread.start()
                    return  # replacement owns the engine now
        # clean drain exit, or final death (respawn budget spent / rebuild
        # failed / draining)
        self._alive = False
        self._draining.set()  # a dead replica must not admit
        self._stopped.set()
        self._drop_calls(f"{self.name}: loop exited")
