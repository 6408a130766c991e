"""Multi-replica request router: placement, admission control, backpressure
(counterpart of ``deepspeed_tpu/serving/router.py``).

The router is the MII-frontend role over our engine tier: it looks at each
replica's ``ReplicaStats`` snapshot and decides, per request, between

- **admit now** — some replica has enough unreserved KV blocks for the
  request's worst case (``ceil(total_tokens / block_size)`` on top of what
  its inbox already promised). Ties break to the replica with the fewest
  outstanding tokens (least-outstanding-tokens placement — outstanding
  tokens, not request count, is what predicts queueing delay under ragged
  batching).
- **queue** — no replica has free blocks, but some replica's bounded queue
  (``max_queue_tokens`` worth of outstanding work) still has room; place
  there and let the engine's own conservative admission pace it.
- **reject** — every live replica is past its queue bound. The caller gets
  ``Overloaded`` carrying a retry-after hint (HTTP 429 upstream). Shedding
  at the door beats timing out inside: an admitted request holds its KV
  reservation while it waits.

``plan_placement`` is a pure function of the stats snapshot so the admission
math is unit-testable without sockets or threads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace

from deepspeed_tpu_torch.serving.engine_loop import (
    EngineLoop,
    ReplicaDraining,
    ReplicaStats,
    TokenStream,
)
from deepspeed_tpu_torch.serving.faults import POINT_SUBMIT, get_fault_injector
from deepspeed_tpu_torch.serving.protocol import CompletionRequest, ProtocolError
from deepspeed_tpu_torch.telemetry import get_telemetry


class Overloaded(RuntimeError):
    """Every replica is past its queue bound (maps to HTTP 429)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Draining(RuntimeError):
    """The whole router is draining (maps to HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before placement (maps to HTTP 504)."""


@dataclass(frozen=True)
class RouterConfig:
    # per-replica bound on outstanding (queued + inflight) tokens before the
    # router sheds load; sized so queue wait stays ~bounded at one replica's
    # worst-case step throughput
    max_queue_tokens: int = 4096
    # Retry-After hint handed to rejected clients
    retry_after_s: float = 1.0
    # --- circuit breaker (per replica, router→replica submit edge) ---
    # consecutive submit failures that trip the breaker open (quarantine)
    breaker_failures: int = 3
    # quarantine dwell before one half-open probe is allowed through
    breaker_reset_s: float = 5.0
    # failover re-placements allowed per request after its replica dies
    max_failovers: int = 1
    # --- tuned-profile loading: autotuning is not ported (ROADMAP.md queue 1
    # item 14); a router given a profile dir raises NotImplementedError ---
    autotune_profile_dir: str | None = None
    autotune_fingerprint: str = ""
    autotune_workload: str = "default"


class _ReplicaHealth:
    """Per-replica circuit breaker: closed → (failures) → open →
    (``breaker_reset_s`` dwell) → half_open → one probe decides. A probe
    failure while half-open re-opens immediately; a success closes."""

    __slots__ = ("failures", "breaker", "opened_at")

    def __init__(self):
        self.failures = 0
        self.breaker = "closed"
        self.opened_at = 0.0

    def note_success(self) -> None:
        self.failures = 0
        self.breaker = "closed"

    def note_failure(self, now: float, threshold: int) -> None:
        self.failures += 1
        if self.breaker == "half_open" or self.failures >= threshold:
            self.breaker = "open"
            self.opened_at = now

    def admissible(self, now: float, reset_s: float) -> bool:
        if self.breaker == "closed":
            return True
        if self.breaker == "open" and now - self.opened_at >= reset_s:
            self.breaker = "half_open"  # next submit is the probe
        return self.breaker == "half_open"


def plan_placement(
    stats: list[ReplicaStats], total_tokens: int, cfg: RouterConfig,
    cached_tokens: list[int] | None = None,
    roles: tuple = ("unified", "decode"),
    tenant_over_share: float = 0.0,
) -> tuple[int | None, str]:
    """Pure admission/placement decision over a stats snapshot.

    ``cached_tokens`` (optional, one entry per replica) is how much of the
    request's prompt each replica's prefix cache already holds: those
    full blocks are spliced (not allocated) on admission, so the worst-case
    block need and the queue-bound token footprint shrink by the cached
    amount — a replica holding the prefix admits requests a cold one must
    queue, and ties prefer the replica that reuses the most.

    ``roles`` restricts which replica roles may take the request. The
    default excludes "prefill": a dedicated prefill replica only ever runs
    handoff prompt stages the cluster places explicitly, so neither initial
    placement NOR failover resubmission can land a decode-bearing request
    on it (the never-fail-over-to-prefill invariant — resubmit() goes
    through this same function).

    ``tenant_over_share`` is the cost meter's fair-share signal: how far
    the requesting tenant's live-KV share exceeds its fair share (0.0 when
    metering is off, the tenant is at/under fair share, or only one tenant
    is active — those cases are byte-identical to the unmetered planner).
    A positive value shrinks the queue bound this request may ride, so a
    hog tenant hits backpressure (429 + retry-after) while the pool is
    contended instead of filling every replica queue — soft steering, never
    a hard quota.

    Returns ``(replica_index, verdict)`` where verdict is one of
    ``"admit"`` (free KV blocks now), ``"queue"`` (fits under the queue
    bound), ``"draining"`` / ``"overloaded"`` (index is None).
    """
    live = [(i, s) for i, s in enumerate(stats)
            if s.alive and not s.draining and s.role in roles]
    if not live:
        return None, "draining"

    def cached(i: int) -> int:
        if not cached_tokens:
            return 0
        return max(0, min(cached_tokens[i], total_tokens))

    def need(i: int, s: ReplicaStats) -> int:
        # cached full blocks are reused, not allocated; the tail still
        # needs ceil((total - block-aligned cached) / block_size)
        return s.worst_blocks(total_tokens
                              - (cached(i) // s.block_size) * s.block_size)

    def load(i: int, s: ReplicaStats) -> int:
        return s.outstanding_tokens + total_tokens - cached(i)

    def cap(s: ReplicaStats) -> int:
        # admit-now capacity: static free-block math, further capped by the
        # replica's measured free-byte headroom when the backend reports it
        # (headroom_blocks == -1 keeps the static path bit-identical)
        free = s.free_blocks - s.pending_blocks
        if s.headroom_blocks >= 0:
            free = min(free, s.headroom_blocks - s.pending_blocks)
        return free

    queue_bound = cfg.max_queue_tokens
    if tenant_over_share > 0.0:
        queue_bound = int(queue_bound / (1.0 + tenant_over_share))
    fits_now = [
        (i, s) for i, s in live
        if need(i, s) <= cap(s)
        and load(i, s) <= queue_bound
    ]
    if fits_now:
        i, _ = min(fits_now,
                   key=lambda t: (t[1].outstanding_tokens, -cached(t[0])))
        return i, "admit"
    can_queue = [
        (i, s) for i, s in live if load(i, s) <= queue_bound
    ]
    if can_queue:
        i, _ = min(can_queue,
                   key=lambda t: (t[1].outstanding_tokens, -cached(t[0])))
        return i, "queue"
    return None, "overloaded"


class ReplicaRouter:
    """Route requests across EngineLoop replicas; own drain + metrics."""

    def __init__(self, replicas: list[EngineLoop],
                 cfg: RouterConfig | None = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.cfg = cfg or RouterConfig()
        self._placements: dict[str, EngineLoop] = {}
        self._health = [_ReplicaHealth() for _ in self.replicas]
        self._failovers: dict[str, int] = {}
        self._faults = get_fault_injector()
        self._draining = False
        if self.cfg.autotune_profile_dir:
            raise NotImplementedError(
                "RouterConfig.autotune_profile_dir: serving autotune profiles are not "
                "ported yet: ROADMAP.md queue 1 item 14 (autotuning)")
        # guards the replicas/_health pair against autoscaler mutation;
        # every read path works on a _snapshot() so a concurrent
        # add/remove never shifts indices mid-decision
        self._replica_lock = threading.Lock()

    # ------------------------------------------- replica pool (autoscaler)
    def _snapshot(self) -> tuple[list[EngineLoop], list[_ReplicaHealth]]:
        with self._replica_lock:
            return list(self.replicas), list(self._health)

    def add_replica(self, replica: EngineLoop) -> None:
        """Grow the pool (autoscaler scale-up). The new replica starts with
        a fresh closed breaker and is placeable on the next submit."""
        with self._replica_lock:
            self.replicas.append(replica)
            self._health.append(_ReplicaHealth())
        if self._draining:
            replica.begin_drain()

    def remove_replica(self, replica: EngineLoop) -> bool:
        """Forget a replica (autoscaler scale-down, after its drain). The
        caller owns draining/joining the loop; in-flight snapshots keep
        working because breaker objects are identity-stable."""
        with self._replica_lock:
            try:
                i = self.replicas.index(replica)
            except ValueError:
                return False
            if len(self.replicas) == 1:
                return False  # never empty the pool
            del self.replicas[i]
            del self._health[i]
        return True

    # ------------------------------------------------------------- submit
    def submit(self, req: CompletionRequest) -> TokenStream:
        """Place + enqueue one request; returns its TokenStream. Raises
        Draining / Overloaded / ProtocolError (request can never fit)."""
        if self._draining:
            raise Draining("server is draining")
        if req.trace_ctx is not None:
            t0 = time.perf_counter()
            try:
                idx, verdict, stream = self._submit_placed(req)
            except Exception as e:
                get_telemetry().tracer.record(
                    req.trace_ctx, "router/submit", t0, time.perf_counter(),
                    verdict=type(e).__name__.lower())
                raise
            get_telemetry().tracer.record(
                req.trace_ctx, "router/submit", t0, time.perf_counter(),
                verdict=verdict, replica=idx)
            return stream
        return self._submit_placed(req)[2]

    def _submit_placed(self, req: CompletionRequest):
        tel = get_telemetry()
        if (req.deadline_s is not None and req.t_submit
                and time.perf_counter() - req.t_submit >= req.deadline_s):
            # already-expired queue entry: shed before placement rather
            # than dispatch doomed work that would hold KV blocks
            if tel.enabled:
                tel.counter(
                    "serving_requests_shed_total",
                    "expired-deadline requests shed pre-placement",
                ).inc(replica="router")
            raise DeadlineExceeded(
                f"request {req.request_id}: deadline_s={req.deadline_s} "
                "expired before placement")
        replicas, health = self._snapshot()
        stats = [r.stats() for r in replicas]
        cap_tokens = max(s.max_request_tokens for s in stats)
        cap_blocks = max(s.max_request_blocks for s in stats)
        if (req.total_tokens > cap_tokens
                or stats[0].worst_blocks(req.total_tokens) > cap_blocks):
            raise ProtocolError(
                f"prompt+max_tokens = {req.total_tokens} exceeds the "
                f"serveable maximum ({cap_tokens} tokens)")
        excluded: set[int] = set()
        while True:
            now = time.perf_counter()
            # mask replicas the breaker quarantines (or that already failed
            # this submit) so plan_placement stays a pure function of stats
            masked = [
                s if (i not in excluded
                      and health[i].admissible(
                          now, self.cfg.breaker_reset_s))
                else replace(s, alive=False)
                for i, s in enumerate(stats)
            ]
            cached = [r.cached_prefix_tokens(req.prompt)
                      for r in replicas]
            # no tenant fair-share steering: the cost meter is ROADMAP.md
            # queue 1 item 14 (tenant_over_share stays 0.0, the reference's
            # unmetered planner)
            idx, verdict = plan_placement(masked, req.total_tokens, self.cfg,
                                          cached_tokens=cached)
            if idx is None:
                if verdict == "draining":
                    # distinguish "every replica is gone/draining" (503)
                    # from "live replicas exist but are quarantined or just
                    # failed this submit" (429 + come back after the dwell)
                    if any(s.alive and not s.draining
                           and s.role != "prefill" for s in stats):
                        raise Overloaded(
                            "all live replicas quarantined by the circuit "
                            "breaker", retry_after_s=self.cfg.breaker_reset_s)
                    raise Draining("server is draining")
                if tel.enabled:
                    tel.counter("serving_requests_rejected_total").inc()
                raise Overloaded(
                    f"all {len(replicas)} replicas past "
                    f"max_queue_tokens={self.cfg.max_queue_tokens}",
                    retry_after_s=self.cfg.retry_after_s)
            replica = replicas[idx]
            # prefetch-on-admission: let the chosen replica's KV tier store
            # stage demoted prefix blocks disk→host while the request sits
            # in its inbox — by admission the restore either completed (tier
            # hit) or is abandoned; the splice is token-identical either way
            kick = getattr(replica, "prefetch_prefix", None)
            if kick is not None:
                kick(req.prompt)
            # record the placement-time prefix credit on the request so the
            # engine can re-validate the actual splice at admission (the
            # probe is advisory — LRU eviction between placement and
            # admission must cost a cold prefill, not over-credited reuse)
            req.cached_tokens_hint = cached[idx] if cached else 0
            try:
                if self._faults.enabled:
                    self._faults.fire(POINT_SUBMIT,
                                      request_id=req.request_id)
                stream = replica.submit(req)
            except ReplicaDraining:
                excluded.add(idx)
                stats[idx] = replica.stats()
                continue
            except Exception as e:  # noqa: BLE001 - breaker feeds on these
                health[idx].note_failure(time.perf_counter(),
                                         self.cfg.breaker_failures)
                if tel.enabled:
                    tel.counter(
                        "serving_submit_failures_total",
                        "router→replica submit failures",
                    ).inc(replica=replica.name, kind=type(e).__name__)
                excluded.add(idx)
                stats[idx] = replica.stats()
                continue
            health[idx].note_success()
            self._placements[req.request_id] = replica
            if tel.enabled:
                tel.counter("serving_requests_admitted_total").inc()
                if verdict == "queue":
                    tel.counter("serving_requests_queued_total").inc()
            return idx, verdict, stream

    def resubmit(self, req: CompletionRequest) -> TokenStream | None:
        """Failover: re-place an in-flight request after its replica died or
        its engine crashed. Deterministic per-request seeds make the replay
        token-identical on any replica, so the frontend can splice the new
        stream over the old one. Returns None when the per-request failover
        budget is spent or the router is draining (caller surfaces the
        original error)."""
        if self._draining:
            return None
        n = self._failovers.get(req.request_id, 0)
        if n >= self.cfg.max_failovers:
            return None
        self._failovers[req.request_id] = n + 1
        self._placements.pop(req.request_id, None)
        try:
            _, _, stream = self._submit_placed(req)
        except Exception:  # noqa: BLE001 - no surviving placement
            return None
        tel = get_telemetry()
        if tel.enabled:
            tel.counter(
                "serving_failovers_total",
                "in-flight requests re-placed on a surviving replica").inc()
        return stream

    def cancel(self, request_id: str) -> None:
        replica = self._placements.pop(request_id, None)
        self._failovers.pop(request_id, None)
        if replica is not None:
            replica.cancel(request_id)
            tel = get_telemetry()
            if tel.enabled:
                tel.counter("serving_requests_cancelled_total").inc()

    def release(self, request_id: str) -> None:
        """Forget a finished request's placement (frontend calls this after
        the terminal event so the map does not grow without bound)."""
        self._placements.pop(request_id, None)
        self._failovers.pop(request_id, None)

    # -------------------------------------------------------------- state
    def state(self) -> str:
        """Healthcheck verdict: ready | degraded | overloaded | draining.

        "degraded" = still serving, but some replica is off its full device
        path (engine ``degraded_mode`` > 0), quarantined by the breaker, or
        dead while others carry the load."""
        replicas, health = self._snapshot()
        if self._draining or not any(
                r.stats().alive and not r.draining for r in replicas):
            return "draining"
        stats = [r.stats() for r in replicas]
        idx, verdict = plan_placement(stats, 1, self.cfg)
        del idx
        if verdict == "overloaded":
            return "overloaded"
        if (any(s.degraded for s in stats)
                or any(not s.alive for s in stats)
                or any(h.breaker != "closed" for h in health)):
            return "degraded"
        return "ready"

    def health(self) -> list[dict]:
        """Per-replica health detail for /healthz: name, role, state
        (healthy | degraded | quarantined | dead), breaker phase, engine
        degradation rung, and containment counters."""
        out = []
        replicas, health = self._snapshot()
        for r, h in zip(replicas, health):
            s = r.stats()
            if not s.alive:
                state = "dead"
            elif h.breaker == "open":
                state = "quarantined"
            elif s.degraded or h.breaker == "half_open":
                state = "degraded"
            else:
                state = "healthy"
            out.append({
                "name": s.name, "role": s.role, "state": state,
                "breaker": h.breaker,
                "alive": s.alive, "draining": s.draining,
                "degraded_mode": s.degraded, "crashes": s.crashes,
                "respawns": s.respawns,
            })
        return out

    def tier_stats(self) -> dict:
        """Per-replica KV tier-store stats (counters, per-tier bytes/blocks)
        for /debug/memory. Replicas without tiering are omitted; empty dict
        when no replica has a tier store."""
        out = {}
        for r in self._snapshot()[0]:
            probe = getattr(r, "kv_tier_stats", None)
            if probe is None:
                continue
            s = probe()
            if s:
                out[r.name] = s
        return out

    def begin_drain(self) -> None:
        """Stop admitting everywhere; non-blocking and signal-safe — the
        frontend registers this as an immediate PreemptionHandler hook."""
        self._draining = True
        for r in self._snapshot()[0]:
            r.begin_drain()

    def drain(self, timeout: float | None = None) -> bool:
        """begin_drain + wait for every replica loop to finish inflight
        work and exit. True if all replicas stopped within the timeout."""
        self.begin_drain()
        ok = True
        for r in self._snapshot()[0]:
            ok = r.join(timeout) and ok
        return ok

    # ------------------------------------------------------------ metrics
    def refresh_metrics(self) -> None:
        """Write current serving gauges into the telemetry registry (called
        at /metrics scrape time; no-op while telemetry is disabled)."""
        tel = get_telemetry()
        if not tel.enabled:
            return
        replicas, health = self._snapshot()
        stats = [r.stats() for r in replicas]
        tel.gauge("serving_replicas").set(len(stats))
        for role in ("unified", "prefill", "decode"):
            n = sum(1 for s in stats if s.role == role)
            if n or role == "unified":
                tel.gauge(
                    "serving_replicas_by_role",
                    "pool size per replica role",
                ).set(n, role=role)
        tel.gauge("serving_replicas_live").set(
            sum(1 for s in stats if s.alive and not s.draining))
        tel.gauge("serving_queue_depth").set(sum(s.queued for s in stats))
        tel.gauge("serving_inflight").set(sum(s.inflight for s in stats))
        tel.gauge("serving_outstanding_tokens").set(
            sum(s.outstanding_tokens for s in stats))
        tel.gauge("serving_kv_free_blocks").set(
            sum(s.free_blocks for s in stats))
        tel.gauge("serving_kv_pending_blocks").set(
            sum(s.pending_blocks for s in stats))
        tel.gauge("serving_draining").set(1.0 if self._draining else 0.0)
        breaker_rank = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
        for r, s, h in zip(replicas, stats, health):
            tel.gauge(
                "replica_breaker_state",
                "0 closed | 1 half-open | 2 open (quarantined)",
            ).set(breaker_rank[h.breaker], replica=r.name, role=s.role)
            tel.gauge(
                "replica_degraded_mode",
                "engine degradation rung (0 full device path)",
            ).set(float(s.degraded), replica=r.name, role=s.role)
