"""Disaggregated prefill/decode serving over the replica tier (counterpart
of ``deepspeed_tpu/serving/cluster.py``).

The single-replica serving path (router → EngineLoop → ragged engine) keeps
prefill and decode time-sliced inside one engine: a long prompt admitted
mid-stream steals whole SplitFuse budgets from every decoding request on the
same replica. This module splits the two phases across *role-tagged*
replicas — the DistServe/Splitwise shape, built from pieces the stack
already has:

- **Prefill replicas** run only the prompt (plus the first token, so the
  handoff is resumable at a real sampling boundary). The engine parks the
  finished request's KV blocks (``put(handoff=True)``) and
  ``export_handoff()`` turns them into a
  :class:`~deepspeed_tpu_torch.inference.ragged.KVHandoff` record — block
  payloads plus the slot-row snapshot, so the decode side restores its
  device row with the in-place row writer admission uses.
- **Decode replicas** ``adopt()`` the record: fresh blocks, one scatter,
  token-identical resume (per-request sampling keys depend only on
  ``(seed, gen_idx)``, never on which engine holds the sequence).
- A **cluster-wide prefix index** mirrors every replica's hash-chained
  prefix-cache keys (allocator publish/evict listeners), so the cluster
  sees prompt reuse on *any* replica. When the chosen prefill replica is
  cold but another replica holds the prefix, the cluster either routes the
  prompt stage to the holder (free, when the holder can take it) or ships
  the published blocks over the transfer channel — taken when the wire
  time beats re-prefilling the covered tokens
  (``tokens * bytes_per_token * 8 / gbps*1e9  <  tokens / prefill_tok_s``).
- A **decode-pool autoscaler** grows/shrinks between ``min``/``max``
  replicas on the SLO burn-rate gauges, draining through ``begin_drain``.

First cut is N replicas in one process: threaded EngineLoops sharing model
params, an in-memory transfer channel. The handoff record and the index
are deliberately transport-agnostic (CPU tensor payloads, primitive
metadata, name-keyed holders, ``KVHandoff.to_bytes``) so a real network
channel can replace
:class:`InMemoryTransferChannel` without touching the engines.

The :class:`ServingCluster` duck-types the ``ReplicaRouter`` surface the
HTTP frontend consumes (submit/cancel/state/health/drain/metrics), so
``ServingFrontend(cluster)`` serves a disaggregated pool unchanged.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace

from deepspeed_tpu_torch.serving.engine_loop import (
    EngineLoop,
    ReplicaDraining,
    TokenStream,
)
from deepspeed_tpu_torch.serving.protocol import (
    FINISH_CANCELLED,
    CompletionRequest,
)
from deepspeed_tpu_torch.serving.router import (
    Draining,
    Overloaded,
    ReplicaRouter,
    RouterConfig,
    plan_placement,
)
from deepspeed_tpu_torch.telemetry import get_telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


@dataclass(frozen=True)
class ClusterConfig:
    """Knobs for the disaggregated serving tier."""

    # decode-pool bounds the autoscaler moves between
    min_decode_replicas: int = 1
    max_decode_replicas: int = 4
    # SLO objectives whose burn rate drives scaling (max over them)
    autoscale_objectives: tuple = ("ttft", "decode_latency")
    # burn >= scale_up_burn grows the pool; burn <= scale_down_burn with
    # headroom shrinks it. 1.0 = exactly consuming the error budget.
    scale_up_burn: float = 1.0
    scale_down_burn: float = 0.25
    # dwell between autoscale actions (either direction)
    autoscale_cooldown_s: float = 30.0
    # --- transfer-vs-prefill cost model ---
    # modeled channel bandwidth (the in-memory channel is effectively
    # infinite; this models the real transport the record is designed for)
    transfer_gbps: float = 10.0
    # modeled prefill throughput of one replica, tokens/s
    prefill_tokens_per_s: float = 50000.0
    # allow shipping published prefix blocks between replicas at all
    enable_prefix_transfer: bool = True
    # per-stage wait bound (prefill collect / decode event gaps)
    stage_timeout_s: float = 300.0


def transfer_beats_prefill(tokens: int, bytes_per_token: int,
                           cfg: ClusterConfig) -> bool:
    """The bytes-vs-prefill-flops estimate: ship ``tokens`` worth of KV
    (``tokens * bytes_per_token`` bytes over the modeled channel) iff the
    wire time undercuts re-running prefill for those tokens. Conservative
    on unknowns: an unreported bandwidth or prefill rate (-1/0) must never
    transfer — a negative divisor would flip the inequality and claim a
    free wire.

    ``bytes_per_token`` comes from the holder engine's
    ``kv_bytes_per_token()``, measured over its actual cache pytree — with
    low-bit KV (``RaggedConfig.quant``, inference/kvquant.py) that is the
    quantized payload + scale bytes, so a ~2x smaller wire cost shifts this
    inequality toward transferring exactly as it should (and codec-matched
    import is enforced at the importer, not here)."""
    if tokens <= 0 or cfg.transfer_gbps <= 0 or cfg.prefill_tokens_per_s <= 0:
        return False
    wire_s = tokens * bytes_per_token * 8.0 / (cfg.transfer_gbps * 1e9)
    prefill_s = tokens / cfg.prefill_tokens_per_s
    return wire_s < prefill_s


class InMemoryTransferChannel:
    """Identity transfer with byte accounting — the single-process stand-in
    for a real KV transport. ``transfer()`` is called off the engine
    threads with a fully host-resident record, which is exactly the
    contract a remote channel needs (serialize, ship, deserialize)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.transfers = 0
        self.bytes_moved = 0
        self.seconds = 0.0

    def transfer(self, record):
        t0 = time.perf_counter()
        nbytes = int(getattr(record, "nbytes", 0))
        dt = time.perf_counter() - t0
        with self._lock:
            self.transfers += 1
            self.bytes_moved += nbytes
            self.seconds += dt
        tel = get_telemetry()
        if tel.enabled:
            tel.counter("kv_transfer_bytes_total",
                        "KV payload bytes moved between replicas"
                        ).inc(nbytes)
            tel.histogram("kv_transfer_seconds",
                          "per-record transfer channel latency").observe(dt)
        return record


class _IndexListener:
    """Bridges one engine's allocator publish/evict stream (engine thread)
    into the cluster index. Installed via ``engine.set_prefix_listener``;
    survives ``reset_state`` (the engine re-installs it and calls
    ``on_reset`` so the index drops this replica's stale keys)."""

    __slots__ = ("_index", "_name")

    def __init__(self, index: "ClusterPrefixIndex", name: str):
        self._index = index
        self._name = name

    def on_publish(self, key) -> None:
        self._index.publish(self._name, key)

    def on_evict(self, key) -> None:
        self._index.evict(self._name, key)

    def on_demote(self, key) -> None:
        # tiered engines: the key left HBM but stays restorable from the
        # replica's host/disk tiers — the index keeps the holder, marked
        # demoted, instead of dropping the entry (fired BEFORE the block id
        # is reusable, so the index never promises payload-less HBM blocks)
        self._index.demote(self._name, key)

    def on_reset(self) -> None:
        self._index.drop_replica(self._name)


class ClusterPrefixIndex:
    """Cluster-wide view of every replica's prefix cache.

    Same hash-chained keying as the per-replica index — keys are
    ``(parent_key, tuple(block_tokens))`` exact-token tuples, fed verbatim
    from allocator listeners — mapped to the replicas holding each chain
    link, each tagged with the TIER the holder keeps it in (0 = HBM,
    1 = demoted to the replica's host/disk tiers but restorable).
    ``best_holder`` walks a prompt's chain and returns the replica with the
    longest contiguous-from-root coverage — the only kind of coverage a
    splice can use — tie-broken toward the holder whose chain sits lowest
    in the hierarchy (HBM beats demoted: no restore cost on arrival)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._holders: dict = {}      # chain key -> {replica name: tier}
        self.hits = 0                 # lookups that found a holder
        self.misses = 0
        self.invalidations = 0        # key-holder pairs dropped by eviction
        self.demotions = 0            # key-holder pairs marked demoted

    # ----------------------------------------------- listener-facing edges
    def publish(self, name: str, key) -> None:
        # also the promotion edge: a demoted key restored to HBM republishes
        # through the allocator, which resets the holder's tier tag to 0
        with self._lock:
            self._holders.setdefault(key, {})[name] = 0

    def evict(self, name: str, key) -> None:
        with self._lock:
            hs = self._holders.get(key)
            if hs is None or name not in hs:
                return
            del hs[name]
            if not hs:
                del self._holders[key]
            self.invalidations += 1

    def demote(self, name: str, key) -> None:
        """The key left ``name``'s HBM for a lower tier: keep the holder —
        routing a request there still reuses the prefix (the replica
        restores it at admission) — but tag it so ties prefer HBM."""
        with self._lock:
            self._holders.setdefault(key, {})[name] = 1
            self.demotions += 1

    def drop_replica(self, name: str) -> int:
        """Forget every key ``name`` holds (replica reset/removed)."""
        dropped = 0
        with self._lock:
            for key in list(self._holders):
                hs = self._holders[key]
                if name in hs:
                    del hs[name]
                    dropped += 1
                    if not hs:
                        del self._holders[key]
            self.invalidations += dropped
        return dropped

    def listener_for(self, name: str) -> _IndexListener:
        return _IndexListener(self, name)

    # ------------------------------------------------------------- queries
    def best_holder(self, prompt, block_size: int,
                    exclude: frozenset = frozenset()) -> tuple[int, str | None]:
        """``(cached_tokens, holder)`` for the longest contiguous-from-root
        chain any single replica (outside ``exclude``) holds for ``prompt``.
        Capped one block short of the prompt like the engine's own match,
        so a full splice still leaves a real first-token forward."""
        prompt = [int(t) for t in prompt]
        n = max(0, (len(prompt) - 1) // block_size)
        best_n, best = 0, None
        cur: set | None = None
        cost: dict = {}  # replica -> total tier depth along its chain
        key = None
        with self._lock:
            for i in range(n):
                key = (key, tuple(prompt[i * block_size:(i + 1) * block_size]))
                hs = self._holders.get(key)
                if not hs:
                    break
                live = (set(hs) if cur is None else cur & set(hs)) - exclude
                if not live:
                    break
                cur = live
                for nm in live:
                    cost[nm] = cost.get(nm, 0) + hs[nm]
                # coverage first, then the cheapest chain (fewest demoted
                # links = least restore work on arrival), then name for
                # determinism
                best_n = i + 1
                best = min(live, key=lambda nm: (cost.get(nm, 0), nm))
        if best_n:
            self.hits += 1
        else:
            self.misses += 1
        return best_n * block_size, best

    def stats(self) -> dict:
        with self._lock:
            entries = len(self._holders)
            demoted = sum(1 for hs in self._holders.values()
                          for t in hs.values() if t > 0)
        return {"entries": entries, "demoted_entries": demoted,
                "hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "demotions": self.demotions}


@dataclass
class _Stage:
    """Per-request live-stage pointer so cancel() reaches the right loop."""

    loop: EngineLoop | None = None
    cancelled: bool = False
    via_router: bool = False  # cold path: router owns the placement


class ServingCluster:
    """Role-aware serving pool: the frontend-facing router surface over
    prefill replicas, decode replicas, a cluster prefix index, a KV
    transfer channel, and (optionally) a decode autoscaler.

    Duck-types ``ReplicaRouter`` for ``ServingFrontend``: ``submit`` runs
    the disaggregated two-stage flow (prefill → handoff → decode) when a
    live prefill replica exists and falls back to the plain single-replica
    path otherwise — and *mid-request* on any stage failure, relying on
    deterministic seeds to replay token-identically.
    """

    def __init__(self, prefill_loops: list[EngineLoop],
                 decode_loops: list[EngineLoop],
                 cfg: ClusterConfig | None = None,
                 router_cfg: RouterConfig | None = None,
                 channel=None):
        self.cfg = cfg or ClusterConfig()
        self.channel = channel or InMemoryTransferChannel()
        self.index = ClusterPrefixIndex()
        for lp in (*prefill_loops, *decode_loops):
            self._attach_index(lp)
        # one router over the WHOLE pool: its role-aware plan_placement
        # keeps whole requests (and failover resubmission) off prefill
        # replicas, while the cluster places prompt stages explicitly
        self.router = ReplicaRouter([*prefill_loops, *decode_loops],
                                    router_cfg)
        self._stages: dict[str, _Stage] = {}
        self._stage_lock = threading.Lock()
        # plain-int counters readable with telemetry off (bench pattern)
        self.disagg_requests = 0
        self.handoffs_ok = 0
        self.handoffs_failed = 0
        self.handoff_seconds = 0.0
        self.prefix_transfers = 0
        self.prefix_transfer_tokens = 0
        self.fallbacks: dict[str, int] = {}
        self.autoscale_events: list[dict] = []

    # --------------------------------------------------------- pool access
    def _attach_index(self, loop: EngineLoop) -> None:
        eng = loop._engine
        if hasattr(eng, "set_prefix_listener"):
            if loop._thread.ident is None:
                eng.set_prefix_listener(self.index.listener_for(loop.name))
            else:
                loop.call(lambda e: e.set_prefix_listener(
                    self.index.listener_for(loop.name)))

    def _pool(self, *roles) -> list[EngineLoop]:
        return [r for r in self.router._snapshot()[0] if r.role in roles]

    def _fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        tel = get_telemetry()
        if tel.enabled:
            tel.counter(
                "cluster_fallbacks_total",
                "disaggregated requests rerouted to the cold path",
            ).inc(reason=reason)

    # ------------------------------------------------------------- submit
    def submit(self, req: CompletionRequest) -> TokenStream:
        """Frontend entry point. Admission control happens HERE (so 429/503
        raise synchronously like the plain router); the two-stage flow then
        runs on a worker thread feeding the returned stream."""
        prefill = [r for r in self._pool("prefill")
                   if r.stats().alive and not r.draining]
        if not prefill:
            # no dedicated prefill tier (or it drained away): plain path
            return self.router.submit(req)
        # decode-pool admission probe — same verdicts/raises as the router,
        # evaluated over the replicas that will own the decode phase
        stats = [r.stats() for r in self.router._snapshot()[0]]
        idx, verdict = plan_placement(stats, req.total_tokens,
                                      self.router.cfg)
        if idx is None:
            if verdict == "draining":
                raise Draining("no live decode replicas")
            tel = get_telemetry()
            if tel.enabled:
                tel.counter("serving_requests_rejected_total").inc()
            raise Overloaded(
                "decode pool past max_queue_tokens="
                f"{self.router.cfg.max_queue_tokens}",
                retry_after_s=self.router.cfg.retry_after_s)
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        out = TokenStream(req.request_id)
        with self._stage_lock:
            self._stages[req.request_id] = _Stage()
        self.disagg_requests += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.counter("cluster_disagg_requests_total",
                        "requests served via prefill/decode handoff").inc()
        worker = threading.Thread(
            target=self._serve_disagg, args=(req, out),
            name=f"cluster-{req.request_id[:12]}", daemon=True)
        worker.start()
        return out

    # ----------------------------------------------- disaggregated pipeline
    def _pick_prefill(self, req: CompletionRequest,
                      exclude: frozenset = frozenset()):
        """Least-outstanding placement over live prefill replicas, holder
        preference via each replica's local prefix probe (mirrors
        plan_placement's tie-break)."""
        pool = [r for r in self._pool("prefill")
                if r.name not in exclude]
        scored = []
        for r in pool:
            s = r.stats()
            if not s.alive or s.draining:
                continue
            scored.append((s.outstanding_tokens,
                           -r.cached_prefix_tokens(req.prompt), r.name, r))
        if not scored:
            return None
        return min(scored)[3]

    def _prefix_plan(self, req: CompletionRequest, chosen: EngineLoop,
                     exclude: frozenset = frozenset()):
        """Cluster-index consult for the prompt stage: route to the holder
        when a better-covered prefill replica exists (free), else ship the
        holder's published blocks to ``chosen`` when the wire beats
        re-prefilling the delta. Returns the (possibly re-routed) loop."""
        bs = chosen._block_size
        local = chosen.cached_prefix_tokens(req.prompt)
        matched, holder = self.index.best_holder(
            req.prompt, bs, exclude=exclude | frozenset((chosen.name,)))
        tel = get_telemetry()
        if tel.enabled:
            tel.counter(
                "cluster_prefix_hits_total" if matched
                else "cluster_prefix_misses_total",
                "prompt-stage lookups against the cluster prefix index",
            ).inc()
        if matched <= local or holder is None:
            return chosen
        by_name = {r.name: r for r in self.router._snapshot()[0]}
        holder_loop = by_name.get(holder)
        if holder_loop is None:
            return chosen
        hs = holder_loop.stats()
        if (holder_loop.role == "prefill" and hs.alive and not hs.draining):
            # routing is free: run the prompt stage where the blocks live
            return holder_loop
        # holder can't take prompt stages (decode role, or draining):
        # ship the blocks if the modeled wire time wins
        delta = matched - local
        if not self.cfg.enable_prefix_transfer:
            return chosen
        try:
            bpt = holder_loop.call(lambda e: e.kv_bytes_per_token())
            if not transfer_beats_prefill(delta, bpt, self.cfg):
                return chosen
            payload = holder_loop.call(
                lambda e: e.export_prefix(req.prompt,
                                          trace=req.trace_ctx))
            if payload is None:
                return chosen
            self.channel.transfer(payload)
            moved = chosen.call(lambda e: e.import_prefix(payload))
        except Exception as e:  # noqa: BLE001 - transfer is best-effort
            log_dist(f"cluster prefix transfer failed: {e}", ranks=[0])
            return chosen
        if moved:
            self.prefix_transfers += 1
            self.prefix_transfer_tokens += moved
            if tel.enabled:
                tel.counter(
                    "cluster_prefix_transfers_total",
                    "prefix-block payloads shipped between replicas",
                ).inc()
        return chosen

    def _serve_disagg(self, req: CompletionRequest, out: TokenStream) -> None:
        try:
            self._serve_disagg_inner(req, out)
        except Exception as e:  # noqa: BLE001 - the stream is the error path
            if out.finish_reason is None and out.error is None:
                out._fail(f"cluster pipeline failed: {e}", code=500,
                          reason="cluster_error")

    def _serve_disagg_inner(self, req: CompletionRequest,
                            out: TokenStream) -> None:
        rid = req.request_id
        stage = self._stages.get(rid) or _Stage()
        timeout = self.cfg.stage_timeout_s
        tel = get_telemetry()

        # ---- stage 1: prompt on a prefill replica -----------------------
        tried: set[str] = set()
        record = None
        while record is None:
            if stage.cancelled:
                out._finish(FINISH_CANCELLED)
                return
            chosen = self._pick_prefill(req, exclude=frozenset(tried))
            if chosen is None:
                self._fallback("no_prefill_replica")
                return self._serve_cold(req, out, skip=0)
            chosen = self._prefix_plan(req, chosen,
                                       exclude=frozenset(tried))
            tried.add(chosen.name)
            pre = replace(req)
            pre.handoff = True
            pre.stream = False
            pre.trace_ctx = req.trace_ctx
            pre.t_submit = req.t_submit
            pre.cached_tokens_hint = chosen.cached_prefix_tokens(req.prompt)
            try:
                pstream = chosen.submit(pre)
            except ReplicaDraining:
                continue
            stage.loop = chosen
            t_h0 = time.perf_counter()
            try:
                _, reason = pstream.collect(timeout=timeout)
            except Exception:  # noqa: BLE001 - structured detail on stream
                if pstream.error_reason in ("replica_died", "engine_crash"):
                    # mid-handoff replica death: nothing reached the client
                    # yet, so a fresh prefill replica (or the cold path)
                    # replays token-identically
                    continue
                self._fallback("prefill_failed")
                return self._serve_cold(req, out, skip=0)
            if reason not in ("length", "stop"):
                # cancelled/timeout during the prompt: the stage is the
                # request's terminal state (handoff parking only happens on
                # a finished prefill). "length" is the normal single-token
                # prefill finish; "stop" means the first token WAS eos (the
                # decode side will retire the import immediately).
                out._finish(reason)
                return
            try:
                record = chosen.call(lambda e: e.export_handoff(rid))
            except Exception:  # noqa: BLE001 - loop died around the call
                continue
            if record is None:
                # parked state vanished (cancel raced the finish)
                out._finish(FINISH_CANCELLED if stage.cancelled
                            else "cancelled")
                return
            dt = time.perf_counter() - t_h0
            self.handoff_seconds += dt
            if tel.enabled:
                tel.histogram(
                    "kv_handoff_seconds",
                    "prompt submit → exported handoff record").observe(dt)

        self.channel.transfer(record)

        # ---- stage 2: adopt on a decode replica -------------------------
        excluded: set[str] = set()
        while True:
            if stage.cancelled:
                out._finish(FINISH_CANCELLED)
                return
            pool = [(r, r.stats()) for r in self._pool("decode", "unified")]
            pool = [(r, s) for r, s in pool
                    if s.alive and not s.draining and r.name not in excluded]
            if not pool:
                self.handoffs_failed += 1
                if tel.enabled:
                    tel.counter("kv_handoffs_total",
                                "prefill→decode handoffs by result"
                                ).inc(result="no_decode_replica")
                self._fallback("no_decode_replica")
                return self._serve_cold(req, out, skip=0)
            idx, _ = plan_placement([s for _, s in pool], req.total_tokens,
                                    self.router.cfg,
                                    roles=("decode", "unified"))
            if idx is not None:
                dloop = pool[idx][0]
            else:
                # pool is past the queue bound: adopt on the least-loaded
                # anyway — the import itself gates on real block capacity
                dloop = min(pool, key=lambda t: t[1].outstanding_tokens)[0]
            try:
                dstream = dloop.adopt(req, record)
            except ReplicaDraining:
                excluded.add(dloop.name)
                continue
            stage.loop = dloop
            ok, delivered = self._pipe(dstream, out, req, skip=0)
            if ok:
                self.handoffs_ok += 1
                if tel.enabled:
                    tel.counter("kv_handoffs_total",
                                "prefill→decode handoffs by result"
                                ).inc(result="ok")
                return
            if dstream.error_reason == "import_rejected" and delivered == 0:
                excluded.add(dloop.name)
                continue
            # decode replica died mid-stream: deterministic seeds make a
            # cold replay token-identical; skip what was already delivered
            self.handoffs_failed += 1
            if tel.enabled:
                tel.counter("kv_handoffs_total",
                            "prefill→decode handoffs by result"
                            ).inc(result="failed")
            self._fallback("decode_died")
            return self._serve_cold(req, out, skip=delivered)

    def _pipe(self, src: TokenStream, out: TokenStream,
              req: CompletionRequest, skip: int) -> tuple[bool, int]:
        """Forward ``src`` events into ``out``, skipping the first ``skip``
        tokens (already on the wire before a failover). Returns
        ``(finished_cleanly, tokens_delivered_to_out)``."""
        delivered = 0
        seen = 0
        try:
            for kind, value in src.events(timeout=self.cfg.stage_timeout_s):
                if kind == "token":
                    seen += 1
                    if seen <= skip:
                        continue
                    out._push(value)
                    delivered += 1
                elif kind == "done":
                    out._finish(value)
                    return True, delivered
                else:
                    return False, delivered
        except TimeoutError:
            self.router.cancel(req.request_id)
            out._fail(
                f"request {req.request_id}: no decode progress within "
                f"{self.cfg.stage_timeout_s:g}s", code=504, reason="timeout")
            return True, delivered  # terminal: don't fall back again
        return False, delivered

    def _serve_cold(self, req: CompletionRequest, out: TokenStream,
                    skip: int) -> None:
        """Cold fallback: the plain router path (decode/unified pool),
        splicing over anything already delivered."""
        stage = self._stages.get(req.request_id) or _Stage()
        stage.via_router = True
        stage.loop = None
        try:
            stream = self.router.submit(req)
        except Overloaded as e:
            out._fail(str(e), code=429, reason="overloaded")
            return
        except Exception as e:  # noqa: BLE001 - draining, protocol, ...
            out._fail(str(e), code=503, reason="fallback_failed")
            return
        while True:
            ok, n = self._pipe(stream, out, req, skip=skip)
            if ok:
                return
            skip += n
            if stream.error_reason in ("replica_died", "engine_crash"):
                replay = self.router.resubmit(req)
                if replay is not None:
                    stream = replay
                    continue
            out._fail(stream.error or "fallback stream failed",
                      code=stream.error_code or 500,
                      reason=stream.error_reason or "fallback_failed")
            return

    # ------------------------------------------- router-compatible surface
    def resubmit(self, req: CompletionRequest):
        return self.router.resubmit(req)

    def cancel(self, request_id: str) -> None:
        with self._stage_lock:
            stage = self._stages.get(request_id)
        if stage is not None:
            stage.cancelled = True
            if stage.loop is not None:
                stage.loop.cancel(request_id)
            if stage.via_router:
                self.router.cancel(request_id)
        else:
            self.router.cancel(request_id)

    def release(self, request_id: str) -> None:
        with self._stage_lock:
            self._stages.pop(request_id, None)
        self.router.release(request_id)

    def state(self) -> str:
        return self.router.state()

    def health(self) -> list[dict]:
        return self.router.health()

    def begin_drain(self) -> None:
        self.router.begin_drain()

    def drain(self, timeout: float | None = None) -> bool:
        return self.router.drain(timeout)

    def tier_stats(self) -> dict:
        return self.router.tier_stats()

    def refresh_metrics(self) -> None:
        self.router.refresh_metrics()
        tel = get_telemetry()
        if not tel.enabled:
            return
        idx = self.index.stats()
        tel.gauge("cluster_prefix_index_entries",
                  "chain keys tracked by the cluster prefix index"
                  ).set(idx["entries"])
        tel.gauge("cluster_prefix_invalidations",
                  "key-holder pairs dropped by eviction/reset"
                  ).set(idx["invalidations"])

    # ------------------------------------------------------------- summary
    def cluster_stats(self) -> dict:
        """Cluster-level observability block (embedded in /healthz and the
        disagg bench JSON)."""
        roles: dict[str, int] = {}
        spec_p = spec_a = 0
        for r in self.router._snapshot()[0]:
            roles[r.role] = roles.get(r.role, 0) + 1
            spec_p += int(getattr(r._engine, "spec_proposed", 0))
            spec_a += int(getattr(r._engine, "spec_accepted", 0))
        return {
            "roles": roles,
            # self-speculative decode economy pooled across replicas (draft
            # history itself is NOT part of the handoff record: the decode
            # side rebuilds it from prompt+generated on adoption)
            "speculation": {"proposed": spec_p, "accepted": spec_a,
                            "acceptance_rate": spec_a / max(spec_p, 1)},
            "prefix_index": self.index.stats(),
            "disagg_requests": self.disagg_requests,
            "handoffs": {"ok": self.handoffs_ok,
                         "failed": self.handoffs_failed,
                         "seconds": self.handoff_seconds},
            "prefix_transfers": self.prefix_transfers,
            "prefix_transfer_tokens": self.prefix_transfer_tokens,
            "kv_transfer": {"transfers": self.channel.transfers,
                            "bytes": self.channel.bytes_moved,
                            "seconds": self.channel.seconds},
            "fallbacks": dict(self.fallbacks),
            "autoscale_events": list(self.autoscale_events),
        }


class DecodeAutoscaler:
    """Grow/shrink the decode pool on SLO burn rate.

    ``tick()`` is the whole policy — call it from a cron, the bench loop,
    or ``start()``'s background thread. Scale-up spawns a replica via the
    factory and splices it into the router + cluster index; scale-down
    drains the least-loaded decode replica (``begin_drain`` → join →
    remove) so in-flight decodes finish untouched."""

    def __init__(self, cluster: ServingCluster, factory,
                 cfg: ClusterConfig | None = None, burn_fn=None):
        self.cluster = cluster
        self.factory = factory          # name -> EngineLoop(role="decode")
        self.cfg = cfg or cluster.cfg
        self._burn_fn = burn_fn
        self._last_action = 0.0
        self._spawned = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._waiters: list[threading.Thread] = []

    # --------------------------------------------------------------- input
    def _burn(self) -> float | None:
        """Max burn rate across the configured objectives; None when no
        objective has enough samples to act on."""
        if self._burn_fn is not None:
            return self._burn_fn()
        slo = get_telemetry().slo
        if slo is None:
            return None
        from deepspeed_tpu_torch.telemetry.slo import MIN_SAMPLES
        burns = []
        for name in self.cfg.autoscale_objectives:
            try:
                s = slo.stats(name)
            except Exception:  # noqa: BLE001 - unknown objective
                continue
            if s and s.get("count", 0) >= MIN_SAMPLES:
                burns.append(float(s.get("burn_rate", 0.0)))
        return max(burns) if burns else None

    def _decode_pool(self) -> list[EngineLoop]:
        return [r for r in self.cluster.router._snapshot()[0]
                if r.role == "decode" and not r.draining]

    # -------------------------------------------------------------- policy
    def tick(self, now: float | None = None) -> int:
        """One policy evaluation: returns +1 (scaled up), -1 (scaled
        down), or 0. Honors min/max bounds and the cooldown dwell."""
        now = time.perf_counter() if now is None else now
        if now - self._last_action < self.cfg.autoscale_cooldown_s:
            return 0
        burn = self._burn()
        if burn is None:
            return 0
        pool = self._decode_pool()
        if (burn >= self.cfg.scale_up_burn
                and len(pool) < self.cfg.max_decode_replicas):
            self._scale_up(now, burn)
            return 1
        if (burn <= self.cfg.scale_down_burn
                and len(pool) > self.cfg.min_decode_replicas):
            self._scale_down(now, burn, pool)
            return -1
        return 0

    def _record(self, direction: str, burn: float, replica: str) -> None:
        self.cluster.autoscale_events.append(
            {"direction": direction, "burn": round(burn, 4),
             "replica": replica})
        tel = get_telemetry()
        if tel.enabled:
            tel.counter("cluster_autoscale_events_total",
                        "decode-pool scale actions").inc(direction=direction)
            tel.gauge("cluster_replicas", "pool size by role").set(
                len(self._decode_pool()), role="decode")

    def _scale_up(self, now: float, burn: float) -> None:
        self._spawned += 1
        name = f"decode-auto-{self._spawned}"
        loop = self.factory(name)
        if loop._thread.ident is None:
            loop.start()
        self.cluster._attach_index(loop)
        self.cluster.router.add_replica(loop)
        self._last_action = now
        self.scale_ups += 1
        self._record("up", burn, name)
        log_dist(f"autoscaler: +{name} (burn {burn:.2f})", ranks=[0])

    def _scale_down(self, now: float, burn: float,
                    pool: list[EngineLoop]) -> None:
        victim = min(pool, key=lambda r: r.stats().outstanding_tokens)
        victim.begin_drain()
        self.cluster.router.remove_replica(victim)
        self._last_action = now
        self.scale_downs += 1
        self._record("down", burn, victim.name)
        log_dist(f"autoscaler: draining {victim.name} (burn {burn:.2f})",
                 ranks=[0])

        def _reap():
            victim.join(timeout=self.cfg.stage_timeout_s)
            self.cluster.index.drop_replica(victim.name)

        t = threading.Thread(target=_reap, name=f"reap-{victim.name}",
                             daemon=True)
        t.start()
        self._waiters.append(t)

    # ---------------------------------------------------------- background
    def start(self, interval_s: float = 5.0) -> "DecodeAutoscaler":
        self._thread = threading.Thread(
            target=self._run, args=(float(interval_s),),
            name="decode-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                log_dist(f"autoscaler tick failed: {e}", ranks=[0])

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        for t in self._waiters:
            t.join(timeout=10.0)


def build_cluster_server(prefill_engines, decode_engines,
                         host: str = "127.0.0.1", port: int = 0,
                         cluster_cfg: ClusterConfig | None = None,
                         router_cfg: RouterConfig | None = None,
                         start: bool = True, fleet_dir: str | None = None):
    """Convenience mirror of ``frontend.build_server`` for a disaggregated
    pool: wrap engines in role-tagged loops, build the cluster, bind the
    HTTP frontend on it. Returns ``(frontend, cluster, loops)``. Warm each
    engine up first, as for ``build_server``; the prefill and decode engines
    may share ``params=``. ``fleet_dir`` raises ``NotImplementedError``
    (fleet observability is ROADMAP.md queue 1 item 14). Drain in the order
    ``cluster.begin_drain()`` -> ``loop.join()`` per loop ->
    ``frontend.close()``."""
    from deepspeed_tpu_torch.serving.frontend import ServingFrontend

    pre = [EngineLoop(e, name=f"prefill-{i}", role="prefill")
           for i, e in enumerate(prefill_engines)]
    dec = [EngineLoop(e, name=f"decode-{i}", role="decode")
           for i, e in enumerate(decode_engines)]
    cluster = ServingCluster(pre, dec, cfg=cluster_cfg,
                             router_cfg=router_cfg)
    frontend = ServingFrontend(cluster, host=host, port=port,
                               fleet_dir=fleet_dir)
    if start:
        for lp in (*pre, *dec):
            lp.start()
        frontend.start()
    return frontend, cluster, (*pre, *dec)
