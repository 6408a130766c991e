"""Ragged / continuous-batching inference engine (counterpart of
``deepspeed_tpu/inference/ragged.py``).

Every engine step processes a fixed budget of tokens that mixes ongoing
decodes (one token per sequence, scheduled first) with prompt-prefill
chunks (SplitFuse). Each token carries (slot, position); new KV is scattered
into a paged block pool before attention, and attention reads each
sequence's blocks through the block table with the hand-written CUDA
kernels (``ops/cuda``). The scheduler pads the token batch to a power-of-2
bucket onto scratch block 0 through the all-zero padding row ``max_seqs``.

Two dispatch paths, as in the JAX engine, with the same scheduling decision
for decision (buckets, admission order, tile plan, padding), so greedy
tokens agree with the JAX engine's in each:

- device-resident state (``RaggedConfig(device_state=True)``, the default):
  per-slot rows (last token, next position, sampling parameters) and the
  block table live on the device and the programs update them in place; a
  dispatch stages one packed int32 buffer, which steady decode does not
  upload at all, and the picked tokens are read back one dispatch behind.
  On a CUDA device the decode-only programs replay as CUDA graphs
  (``inference/cuda_graphs.py``);
- host-staged (``device_state=False``): every dispatch uploads its token,
  slot, position and table arrays and reads its tokens back at once.

Both run plain or tiled SplitFuse steps, and with ``decode_run_ahead`` K
greedy decode steps in one dispatch when every running sequence decodes.
With ``fused_chunk`` >= 2 every turn goes through fused mixed chunks
instead: one program runs a mixed SplitFuse step and then up to
``fused_chunk`` - 1 decode steps for its decode rows, and up to
``pipeline_depth`` chunks are in flight before the oldest is read back (the
next chunk's decode feed stays on the device); ``warmup()`` prepares the
program family before serving. On a CUDA device with device-resident state
every fused program, mixed or not, replays as a CUDA graph.

With ``sched_steps`` >= 2 (device-resident state only; the host-staged path
ignores it, as the JAX engine does) every all-decode turn goes to the
multi-step scheduler: one program runs up to ``sched_steps`` decode
iterations and retires rows on EOS and length inside the program, exiting
when every row has retired (on the card a CUDA graph whose iterations sit
under conditional nodes, ``inference/cuda_graphs.py``). With ``spec_draft``
D > 0 each iteration also drafts up to D tokens a row from the row's own
token history (prompt lookup, ``inference/sampling.py``) and verifies them
in the same forward. Verification is exact-match against the model's own
greedy picks, so the output is token-identical to plain decoding; for
sampled requests that holds only once seeded sampling is ported (``put``
refuses ``temperature > 0`` until then). With ``fused_chunk`` set, mixed
waves run as fused chunks and all-decode turns as scheduler programs.

The prefix cache, KV tiers, low-bit pools, handoff, telemetry, fault
injection and seeded sampling are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.cuda_graphs import LoopProgram, ProgramCache
from deepspeed_tpu_torch.inference.sampling import accept_drafts, propose_ngram_drafts
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.models.paged import speculative_lane_layout
from deepspeed_tpu_torch.utils.logging import log_dist


class BlockedAllocator:
    """Ref-counted free-list allocator over the KV block pool
    (reference ``inference/v2/ragged/blocked_allocator.py``, grown the
    SGLang/vLLM prefix-cache direction: blocks carry refcounts so several
    sequences can share one prefix block, and retired prompt blocks can be
    *published* into a hash-chained prefix index instead of freed).

    Block 0 is reserved as the scratch block that padding tokens write into;
    it is never handed out. Published blocks with refcount 0 sit in an LRU
    and are evicted on demand when ``allocate`` finds the free list dry —
    the prefix cache is strictly free-memory-funded: ``free_blocks`` counts
    evictable cached blocks as allocatable, so admission reservations see
    the same capacity they would without caching and can never deadlock on
    retained blocks.

    Prefix keys are exact hash-chains: ``key = (parent_key, block_tokens)``
    per full block (structural sharing keeps them cheap); exact tuples
    rather than digests so a hash collision can never splice wrong KV.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the scratch block)")
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> lowest first
        self.num_blocks = num_blocks
        self._refs = [0] * num_blocks
        # prefix cache state (inert until publish() is first called)
        self._index: dict = {}   # chain key -> block id
        self._keys: dict[int, Any] = {}  # block id -> its chain key
        self._lru: dict[int, None] = {}  # refcount-0 published blocks, LRU->MRU
        self.evictions = 0  # cumulative cached blocks reclaimed under pressure
        self.allocated_total = 0  # cumulative blocks handed out (all paths)
        # optional publish/evict listener (serving cluster prefix index):
        # an object with on_publish(key) / on_evict(key), called on the
        # engine thread as keys enter/leave the index. None = standalone.
        self.listener = None
        # optional tiering hook: demote_hook(block, key) -> bool is called
        # as an LRU eviction reclaims a published block, WHILE the payload
        # is still intact — True means the block was captured into a lower
        # tier rather than dropped. None = untiered.
        self.demote_hook = None

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free + evictable (refcount-0 cached)."""
        return len(self._free) + len(self._lru)

    @property
    def busy_blocks(self) -> int:
        """Blocks holding live or retained KV right now: everything except
        the scratch block and the truly-free list."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently published in the prefix index (any refcount)."""
        return len(self._keys)

    @property
    def retained_blocks(self) -> int:
        """Refcount-0 cached blocks held back from the free list (the
        memory the prefix cache is actually occupying right now)."""
        return len(self._lru)

    def allocate(self, n: int) -> list[int]:
        if n > self.free_blocks:
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {self.free_blocks} free"
            )
        while len(self._free) < n:
            self._evict_lru()
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.allocated_total += n
        return out

    def _evict_lru(self) -> None:
        b = next(iter(self._lru))  # oldest entry (LRU order)
        del self._lru[b]
        key = self._keys.pop(b)
        del self._index[key]
        demoted = False
        if self.demote_hook is not None:
            # tiering: capture the payload NOW — once the id is back on the
            # free list the next allocation may rewrite it
            try:
                demoted = bool(self.demote_hook(b, key))
            except Exception:  # noqa: BLE001 - demotion is best-effort
                demoted = False
        self.evictions += 1
        if self.listener is not None:
            # notify BEFORE the id returns to the free list: a cluster-index
            # entry must never promise a block its replica could already be
            # rewriting. A captured block demotes (the key stays servable
            # from a lower tier); an uncaptured one is a plain eviction.
            on_demote = getattr(self.listener, "on_demote", None)
            if demoted and on_demote is not None:
                on_demote(key)
            else:
                self.listener.on_evict(key)
        self._free.append(b)

    def shrink_retained(self, budget: int) -> int:
        """Evict LRU cached blocks until at most ``budget`` refcount-0
        blocks stay retained. Returns how many blocks were evicted; a budget
        at or above the current retention is a no-op."""
        n = 0
        while len(self._lru) > max(0, budget):
            self._evict_lru()
            n += 1
        return n

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block; a block reaching refcount 0 returns
        to the free list, or to the evictable LRU if it is published."""
        for b in blocks:
            if b == 0 or b >= self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if self._refs[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                if b in self._keys:
                    self._lru[b] = None  # dict preserves insertion = MRU last
                else:
                    self._free.append(b)

    # ------------------------------------------------------- prefix cache
    def lookup(self, key) -> int | None:
        """Block id published under ``key``, or None. Read-only (no LRU
        touch) so a router can probe concurrently."""
        return self._index.get(key)

    def acquire(self, blocks: list[int]) -> None:
        """Take a reference on cached blocks (a prefix hit splicing them
        into a sequence's block table). A refcount-0 block leaves the
        evictable LRU."""
        for b in blocks:
            if self._refs[b] == 0:
                del self._lru[b]
            self._refs[b] += 1

    def publish(self, block: int, key) -> bool:
        """Register ``block``'s content under its chain key (called at
        sequence release, BEFORE ``free``). Returns False when the key is
        already cached (dedupe: the existing block stays authoritative)."""
        if key in self._index:
            return False
        self._index[key] = block
        self._keys[block] = key
        if self.listener is not None:
            self.listener.on_publish(key)
        return True


@dataclass
class RaggedConfig:
    """Engine sizing. ``max_tokens_per_step`` is the SplitFuse token budget."""

    max_tokens_per_step: int = 256
    max_seqs: int = 8
    block_size: int = 16
    num_blocks: int = 257  # 256 usable + scratch
    max_blocks_per_seq: int = 32
    # decode run-ahead: when every running sequence decodes, run up to this
    # many greedy decode steps in ONE dispatch (the next token fed back on
    # the device), rounded down to a power of two. 0 disables.
    decode_run_ahead: int = 0
    # tiled prefill: lay prefill chunks at tile-aligned offsets so the tiled
    # kernel fetches each KV block once per TILE instead of once per token.
    # 0 disables (per-token kernel for everything).
    prefill_tile: int = 0
    # with arrivals queued but unadmittable (a free slot, but the pool cannot
    # cover the reservation), run-ahead fuses at most this many steps:
    # decode progress is what frees blocks
    run_ahead_admission_cap: int = 8
    # fused mixed chunks (>= 2 enables): EVERY dispatch is one program that
    # runs the mixed SplitFuse step (decodes + prefill chunks) and then
    # fused_chunk - 1 further greedy decode steps for the decode rows, the
    # next token fed back on the device; arrivals ride step 0 of the same
    # program. 0 disables.
    fused_chunk: int = 0
    # fused chunks in flight before the oldest is read back: chunk t + 1 is
    # dispatched before chunk t's tokens reach the host, its decode feed
    # read from a per-slot device row (bounded speculation; EOS and budgets
    # reconciled on readback)
    pipeline_depth: int = 2
    # device-resident scheduler state: slot rows and the block table live on
    # the device, steady decode stages nothing, readback runs one dispatch
    # behind. False: the host-staged path (token-identical).
    device_state: bool = True
    # device-side multi-step decode scheduler (>= 2 enables): when every
    # running sequence decodes, ONE program runs up to sched_steps decode
    # steps and retires rows on EOS and length inside the program (retired
    # rows run on the scratch slot; the loop exits once every row retired)
    # and returns each row's steps taken, so the host only reconciles.
    # Needs device_state (inert on the host-staged path, token-identical).
    sched_steps: int = 0
    # self-speculative decoding depth (> 0 enables; needs sched_steps >= 2):
    # each scheduler iteration drafts up to spec_draft tokens a row by
    # n-gram prompt lookup over the row's own token history and verifies
    # them in the same forward; exact-match verification keeps the output
    # that of plain decoding
    spec_draft: int = 0
    # suffix length the prompt-lookup draft matches
    spec_ngram: int = 3

    @property
    def max_seq_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq


@dataclass
class _SeqState:
    """Host descriptor of one request."""

    uid: Any
    prompt: list[int]
    max_new_tokens: int
    eos_token_id: int | None = None
    slot: int = -1
    pos: int = 0  # tokens whose KV has been scheduled into the cache
    generated: list[int] = field(default_factory=list)
    blocks: list[int] = field(default_factory=list)
    reserved_remaining: int = 0  # worst-case blocks reserved but not yet held
    # decode steps where this sequence stalled on KV-pool pressure
    preemptions: int = 0
    # abort path: absolute perf_counter deadline (0.0 = none) and terminal
    # status — "finished" until cancel()/deadline expiry flips it to
    # "cancelled"/"timeout", which makes ``finished`` true so the next step
    # retires the sequence
    deadline: float = 0.0
    status: str = "finished"
    # dispatches in flight (not yet reconciled) that reference this
    # sequence: its blocks and slot are released only when they drain
    refs: int = 0

    def token_at(self, p: int) -> int:
        if p < len(self.prompt):
            return self.prompt[p]
        return self.generated[p - len(self.prompt)]

    @property
    def in_decode(self) -> bool:
        return self.pos >= len(self.prompt)

    @property
    def finished(self) -> bool:
        if self.status != "finished":
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated) and self.generated[-1] == self.eos_token_id


def _cast_params(tree, dtype: torch.dtype, device: torch.device):
    if isinstance(tree, dict):
        return {k: _cast_params(v, dtype, device) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


class RaggedInferenceEngine:
    """Continuous-batching engine over a ``ModelSpec`` with ragged hooks.

    ``put()`` requests at any time; ``step()`` advances every admitted
    request by up to one token (decodes) and/or one prompt chunk (prefills)
    in one forward; finished sequences free their blocks and their slot is
    reused immediately. Runs on ``cuda:0`` unless ``device`` names another
    device; without a CUDA device and without ``device`` it raises.
    """

    def __init__(self, model: ModelSpec, ragged_config: RaggedConfig | None = None,
                 dtype=torch.bfloat16, params: dict | None = None, seed: int = 0,
                 eos_token_id: int | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = ragged_config or RaggedConfig()
        if self.cfg.fused_chunk == 1 or self.cfg.fused_chunk < 0:
            raise ValueError("fused_chunk must be 0 (off) or >= 2")
        if self.cfg.fused_chunk and self.cfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.cfg.sched_steps == 1 or self.cfg.sched_steps < 0:
            raise ValueError("sched_steps must be 0 (off) or >= 2")
        if self.cfg.spec_draft:
            if self.cfg.sched_steps < 2:
                raise ValueError("spec_draft requires sched_steps >= 2")
            if self.cfg.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
        self.spec = model
        if self.spec.ragged_forward_fn is None or self.spec.init_paged_cache_fn is None:
            raise ValueError(f"model {self.spec.name} has no ragged/paged support")
        self.dtype = dtype
        self.eos_token_id = eos_token_id

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.spec.init_fn(gen, dtype, self.device)
        self.params = _cast_params(params, dtype, self.device)
        self.cache = self.spec.init_paged_cache_fn(
            self.cfg.num_blocks, self.cfg.block_size, dtype, self.device)
        self.allocator = BlockedAllocator(self.cfg.num_blocks)
        # row max_seqs is the all-zeros padding row -> scratch block 0
        self.block_tables = np.zeros(
            (self.cfg.max_seqs + 1, self.cfg.max_blocks_per_seq), np.int32
        )
        self._free_slots = list(range(self.cfg.max_seqs - 1, -1, -1))
        # blocks promised to admitted sequences but not yet allocated;
        # admission reserves worst case (prompt + max_new) so an admitted
        # sequence can always finish
        self._reserved = 0
        self._queued: list[_SeqState] = []
        self._running: dict[int, _SeqState] = {}  # slot -> seq
        self._results: dict[Any, _SeqState] = {}
        # token-batch size buckets: decode-heavy steps run a small size
        # instead of padding to the full SplitFuse budget
        b = 4
        self._buckets = []
        while b < self.cfg.max_tokens_per_step:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.cfg.max_tokens_per_step)
        self._use_tiles = self.cfg.prefill_tile > 0
        if self._use_tiles and not self.spec.supports_prefill_tiles:
            raise ValueError(
                f"prefill_tile={self.cfg.prefill_tile} but model "
                f"{self.spec.name} does not accept prefill_tiles (its "
                "ragged_forward has no tiled path); it would silently no-op")
        if self._use_tiles and self.cfg.prefill_tile > self.cfg.max_tokens_per_step:
            raise ValueError("prefill_tile exceeds max_tokens_per_step")
        # decode-region buckets for the tiled path (decodes <= max_seqs)
        self._dec_buckets = []
        b = 4
        while b < self.cfg.max_seqs:
            self._dec_buckets.append(b)
            b *= 2
        self._dec_buckets.append(self.cfg.max_seqs)
        # fused mixed-chunk pipeline (cfg.fused_chunk): dispatched chunks not
        # yet read back, oldest first
        self._inflight_chunks: list[dict] = []
        # host-staged fused chunks: each slot's latest token on the device (+1
        # scratch row), which chunk t + 1's decode feed reads before chunk t
        # is read back
        self._slot_toks = torch.zeros(self.cfg.max_seqs + 1, dtype=torch.int32,
                                      device=self.device)
        # host mirror of which slots have a valid device-side next token
        self._slot_feed = np.zeros(self.cfg.max_seqs + 1, bool)
        # ---- device-resident scheduler state (cfg.device_state) ----
        # per-slot rows (+1 scratch row at max_seqs): last token, next
        # position, seed, prompt length, temperature, top-k, top-p. Written
        # in place at admission (_write_slot_row) and by the programs
        # themselves (picked token, advanced position).
        s1 = self.cfg.max_seqs + 1
        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._dev_state = (
            torch.zeros(s1, **i32), torch.zeros(s1, **i32), torch.zeros(s1, **i32),
            torch.zeros(s1, **i32), torch.zeros(s1, **f32), torch.zeros(s1, **i32),
            torch.ones(s1, **f32))
        # device block table: the host table stays ground truth; rows dirtied
        # by allocation or release are delta-uploaded into this one tensor
        # (the programs and their graphs read it in place)
        self._bt_dev = torch.zeros((s1, self.cfg.max_blocks_per_seq), **i32)
        self._bt_dirty: set[int] = set()
        # one staging buffer per staged length: (bytes last written, tensor)
        self._staging: dict[int, list] = {}
        # dispatched, not yet reconciled (readback one dispatch behind)
        self._pending: list[dict] = []
        self.programs = ProgramCache(self.device)
        self._on_card = self.device.type == "cuda"
        # self-speculative draft state: each slot's token history (prompt +
        # generated, by position), which the scheduler program appends to
        # and drafts from. Any other path that moves a slot marks its row
        # stale, and a stale row is uploaded from the host's prompt +
        # generated before the slot's next scheduler dispatch.
        self._hist_dev = (torch.zeros((s1, self.cfg.max_seq_len), **i32)
                          if self.cfg.spec_draft else None)
        self._hist_stale = np.ones(s1, bool)
        # a scheduler dispatch declined because stale history rows cannot be
        # uploaded yet (dispatches in flight): the turn reconciles instead of
        # falling through to a per-step dispatch
        self._sched_wait = False
        self._sched_programs: dict = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        # scheduling and dispatch accounting
        self.tokens_scheduled = 0
        self.tokens_padded = 0
        self.dispatch_count = 0
        self.preemptions = 0
        self.host_stage_ns = 0
        self.readback_ns = 0
        self.h2d_bytes = 0
        # steady decode: device dispatches whose rows all decode over the
        # previous dispatch's batch (the same slots in the same staged
        # layout). Their staging bytes, and the H2D bytes of those among
        # them that found no table row dirty (a row grows a block now and
        # then, and is uploaded), are both 0 when the path works.
        self.stage_bytes = 0
        self.steady_dispatches = 0
        self.steady_stage_bytes = 0
        self.steady_clean_dispatches = 0
        self.steady_h2d_bytes = 0
        self._last_batch = None
        # run-ahead dispatches and the real tokens they scheduled (K a row)
        self.run_ahead_dispatches = 0
        self.run_ahead_tokens = 0
        # model forwards dispatched: one a step, K a run-ahead chunk, a fused
        # chunk's step plus its scan steps, and a scheduler program's
        # iterations (counted when its tokens are read back)
        self.forwards = 0
        # scheduler dispatches and the iterations they ran
        self.sched_dispatches = 0
        self.sched_iterations = 0
        log_dist(
            f"RaggedInferenceEngine: model={self.spec.name} device={self.device} "
            f"budget={self.cfg.max_tokens_per_step} max_seqs={self.cfg.max_seqs} "
            f"blocks={self.cfg.num_blocks}x{self.cfg.block_size}", ranks=[0],
        )

    # ------------------------------------------------------------------ put
    def put(self, uid, prompt_tokens, max_new_tokens: int = 64,
            eos_token_id: int | None = None, temperature: float = 0.0,
            deadline_s: float | None = None) -> None:
        """Enqueue a greedy request. Admission into the running batch happens
        inside ``step()`` as slots/budget free up. ``deadline_s`` bounds the
        request's whole lifetime (queue wait included): past it the sequence
        is released on the next ``step()`` with status ``timeout``."""
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"request length {total} exceeds engine max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        worst = -(-total // self.cfg.block_size)
        if worst > min(self.cfg.num_blocks - 1, self.cfg.max_blocks_per_seq):
            raise ValueError(
                f"request needs {worst} KV blocks but at most "
                f"{min(self.cfg.num_blocks - 1, self.cfg.max_blocks_per_seq)} "
                "are available per sequence — it could never be admitted"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling (temperature > 0) is not ported yet: it waits for "
                "the ROADMAP.md item 'Seeded sampling with exact threefry'")
        # re-putting a retired uid supersedes its old record
        self._results.pop(uid, None)
        self._queued.append(_SeqState(
            uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id if eos_token_id is not None else self.eos_token_id,
            deadline=(time.perf_counter() + deadline_s) if deadline_s else 0.0,
        ))

    @property
    def has_work(self) -> bool:
        return bool(self._queued or self._running or self._inflight_chunks or self._pending)

    @property
    def finished_uids(self):
        """UIDs of completed requests."""
        return set(self._results)

    def get_request(self, uid):
        """Host descriptor of a request at any lifecycle stage (queued,
        running, or retired), or None if the uid is unknown."""
        seq = self._results.get(uid)
        if seq is not None:
            return seq
        for seq in self._running.values():
            if seq.uid == uid:
                return seq
        for seq in self._queued:
            if seq.uid == uid:
                return seq
        return None

    def cancel(self, uid) -> bool:
        """Abort a request: a queued request is dropped and a running one
        releases its KV blocks on the next ``step()``. Returns False if the
        uid is unknown or already retired."""
        for seq in self._queued:
            if seq.uid == uid and seq.status == "finished":
                seq.status = "cancelled"
                return True
        for seq in self._running.values():
            if seq.uid == uid and seq.status == "finished":
                seq.status = "cancelled"
                return True
        return False

    def _sweep_aborts(self) -> None:
        """Retire cancelled/deadline-expired sequences (queued AND running)
        at the top of every step, so an abort never outlives one step. A
        running one referenced by a dispatch in flight (``refs`` > 0) is
        released by ``_reconcile_pending`` or ``_reconcile_oldest`` as its
        references drain."""
        now = None
        for seq in (*self._queued, *self._running.values()):
            if seq.status == "finished" and seq.deadline:
                if now is None:
                    now = time.perf_counter()
                if now >= seq.deadline:
                    seq.status = "timeout"
        aborted = [s for s in self._queued if s.status != "finished"]
        if aborted:
            self._queued = [s for s in self._queued if s.status == "finished"]
            for seq in aborted:
                self._results[seq.uid] = seq
        for seq in list(self._running.values()):
            if seq.status != "finished" and seq.refs == 0:
                self._release(seq)

    # ------------------------------------------------------------ capacity
    def _worst_case_blocks(self, seq: _SeqState) -> int:
        total = len(seq.prompt) + seq.max_new_tokens
        return -(-total // self.cfg.block_size)

    def _ensure_capacity(self, seq: _SeqState, upto: int) -> bool:
        """Grow seq's block table to cover positions [0, upto); False if the
        pool can't satisfy it right now. Admitted sequences draw from their
        admission-time reservation, so this cannot fail for them."""
        need = -(-upto // self.cfg.block_size) - len(seq.blocks)
        if need <= 0:
            return True
        if need > self.allocator.free_blocks:
            return False
        if len(seq.blocks) + need > self.cfg.max_blocks_per_seq:
            return False
        new = self.allocator.allocate(need)
        start = len(seq.blocks)
        seq.blocks.extend(new)
        drawn = min(seq.reserved_remaining, len(new))
        seq.reserved_remaining -= drawn
        self._reserved -= drawn
        self.block_tables[seq.slot, start:start + len(new)] = new
        self._bt_dirty.add(seq.slot)
        return True

    def _release(self, seq: _SeqState) -> None:
        self._reserved -= seq.reserved_remaining  # return unused reservation
        seq.reserved_remaining = 0
        self.allocator.free(seq.blocks)
        seq.blocks = []
        self.block_tables[seq.slot, :] = 0
        self._bt_dirty.add(seq.slot)
        self._slot_feed[seq.slot] = False
        self._free_slots.append(seq.slot)
        del self._running[seq.slot]
        seq.slot = -1
        self._results[seq.uid] = seq

    def _table_view(self, max_pos: int) -> np.ndarray:
        """Slice the block table to the bucketed block count covering
        ``max_pos`` (the highest position any token in this dispatch will
        touch). Tables up to 64 blocks wide pass through whole."""
        return self.block_tables[:, :self._table_width(max_pos)]

    def _table_width(self, max_pos: int) -> int:
        mb = self.cfg.max_blocks_per_seq
        if mb <= 64:
            return mb
        need = max_pos // self.cfg.block_size + 1
        b = 16
        while b < need:
            b *= 4
        return min(b, mb)

    # ------------------------------------------------------------ scheduling
    def _schedule_decodes(self, budget: int, tokens, slots, positions,
                          emit) -> int:
        """Pass 1: ongoing decodes first (latency priority, FastGen policy).
        Writes into the arrays from index 0, returns the count."""
        n = 0
        for seq in list(self._running.values()):
            if not seq.in_decode or n >= budget:
                continue
            if not self._ensure_capacity(seq, seq.pos + 1):
                # pool pressure: this seq stalls (is preempted) for one step
                seq.preemptions += 1
                self.preemptions += 1
                continue
            tokens[n] = seq.token_at(seq.pos)
            slots[n] = seq.slot
            positions[n] = seq.pos
            emit.append((n, seq))
            seq.pos += 1
            n += 1
        return n

    def _admit_queued(self) -> None:
        """Pass 2: admit queued requests in arrival order while slots remain
        (their prompt chunks are scheduled by pass 3); admission reserves the
        request's worst-case block count so admitted work always finishes."""
        while self._queued and self._free_slots:
            seq = self._queued[0]
            worst = self._worst_case_blocks(seq)
            if worst > self.allocator.free_blocks - self._reserved:
                break  # pool pressure: retry admission as blocks free up
            self._queued.pop(0)
            seq.slot = self._free_slots.pop()
            seq.reserved_remaining = worst
            self._reserved += worst
            self._running[seq.slot] = seq
            if self.cfg.device_state:
                self._write_slot_row(seq)

    def _plan_prefill_tiles(self, nd: int, budget: int):
        """Pick tile-aligned prompt chunks for this step. Returns
        ``(chunks, nt)``: ``chunks`` is ``[(seq, tile0, take)]`` with
        ``tile0`` the chunk's first tile index relative to the tile region;
        ``nt`` the padded tile count. Does NOT advance ``seq.pos``."""
        ct = self.cfg.prefill_tile
        ntiles_cap = max(0, (budget - nd) // ct)
        tiles_used = 0
        chunks: list[tuple[_SeqState, int, int]] = []
        for seq in list(self._running.values()):
            if seq.finished or seq.in_decode or tiles_used >= ntiles_cap:
                continue
            avail = (ntiles_cap - tiles_used) * ct
            take = min(avail, len(seq.prompt) - seq.pos)
            while take and not self._ensure_capacity(seq, seq.pos + take):
                take -= 1  # partial chunk under pool pressure
            if take <= 0:
                continue
            chunks.append((seq, tiles_used, take))
            tiles_used += -(-take // ct)
        if tiles_used == 0:
            return chunks, 0
        nt = 1
        while nt < tiles_used:
            nt *= 2
        nt = min(nt, max(1, ntiles_cap))
        if nt < tiles_used:  # cap can be non-power-of-2
            nt = tiles_used
        return chunks, nt

    def _deadlock_guard(self, n: int) -> None:
        if n == 0:
            # has_work but nothing schedulable: every sequence is stalled on
            # KV-pool capacity and nothing can ever free a block
            raise RuntimeError(
                "KV pool deadlock: all sequences stalled waiting for blocks "
                f"({self.allocator.free_blocks} free of "
                f"{self.cfg.num_blocks - 1} usable); enlarge num_blocks or "
                "lower max_seqs/max_new_tokens"
            )

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Copy a host array to the engine's device (byte-accounted)."""
        self.h2d_bytes += arr.nbytes
        return torch.tensor(arr, device=self.device)

    def _note_dispatch(self, t0: float, forwards: int = 1) -> None:
        self.host_stage_ns += int((time.perf_counter() - t0) * 1e9)
        self.dispatch_count += 1
        self.forwards += forwards

    def _emit_tokens(self, logits, emit) -> dict:
        """Shared step epilogue: greedy pick at the emit indices, extend the
        sequences, release finished ones."""
        out: dict = {}
        if emit:
            idx = torch.tensor([i for i, _ in emit], device=logits.device)
            picked = torch.argmax(logits[idx].float(), dim=-1).tolist()
            for (_, seq), tok in zip(emit, picked):
                seq.generated.append(int(tok))
                out[seq.uid] = int(tok)
                if seq.finished:
                    self._release(seq)
        return out

    # ------------------------------------------------------------------ step
    def step(self) -> dict:
        """One SplitFuse step. Returns {uid: token} for sequences that emitted
        a token this step."""
        if not self.has_work:
            return {}
        self._sweep_aborts()
        if not self.has_work:
            return {}  # the sweep retired everything schedulable
        if self.cfg.fused_chunk >= 2:
            if self.cfg.sched_steps >= 2 and self.cfg.device_state:
                return self._step_fused_sched()
            return self._step_fused()
        if self.cfg.device_state:
            return self._step_device()
        # admission first: a newly admitted sequence is in prefill, which
        # disables run-ahead for this step (the JAX engine's order)
        self._admit_queued()
        ahead = self._try_decode_run_ahead()
        if ahead is not None:
            return ahead
        if self._use_tiles:
            return self._step_tiled()
        return self._step_plain()

    def _step_plain(self) -> dict:
        """Decodes first, then prefill chunks packed back to back; every
        token goes through the per-token paged kernel."""
        t0 = time.perf_counter()
        budget = self.cfg.max_tokens_per_step
        tokens = np.zeros(budget, np.int32)
        slots = np.full(budget, self.cfg.max_seqs, np.int32)  # padding row
        positions = np.zeros(budget, np.int32)
        emit: list[tuple[int, _SeqState]] = []
        n = self._schedule_decodes(budget, tokens, slots, positions, emit)

        # prefill chunks for running prompts within the remaining budget
        for seq in list(self._running.values()):
            if seq.in_decode or n >= budget:
                continue
            take = min(budget - n, len(seq.prompt) - seq.pos)
            while take and not self._ensure_capacity(seq, seq.pos + take):
                take -= 1  # partial chunk under pool pressure
            if take <= 0:
                continue
            sl = slice(n, n + take)
            tokens[sl] = seq.prompt[seq.pos:seq.pos + take]
            slots[sl] = seq.slot
            positions[sl] = np.arange(seq.pos, seq.pos + take, dtype=np.int32)
            seq.pos += take
            n += take
            if seq.pos == len(seq.prompt):
                emit.append((n - 1, seq))  # last prompt token -> first new token

        self._deadlock_guard(n)
        bucket = next(b for b in self._buckets if b >= n)
        self.tokens_scheduled += n
        self.tokens_padded += bucket - n

        max_pos = int(positions[:n].max(initial=0))
        logits, self.cache = self.spec.ragged_forward_fn(
            self.params, self._h2d(tokens[:bucket]), self._h2d(slots[:bucket]),
            self._h2d(positions[:bucket]), self._h2d(self._table_view(max_pos)),
            self.cache)
        self._note_dispatch(t0)
        return self._emit_tokens(logits, emit)

    def _step_tiled(self) -> dict:
        """One SplitFuse step with tile-aligned prefill layout: tokens
        [0, ND) are decodes (bucketed), the rest are prefill chunks laid at
        tile boundaries so the tiled kernel fetches each KV block once per
        tile (see RaggedConfig.prefill_tile)."""
        ct = self.cfg.prefill_tile
        budget = self.cfg.max_tokens_per_step
        t0 = time.perf_counter()
        tokens = np.zeros(budget + ct, np.int32)
        slots = np.full(budget + ct, self.cfg.max_seqs, np.int32)
        positions = np.zeros(budget + ct, np.int32)
        emit: list[tuple[int, _SeqState]] = []
        n_dec = self._schedule_decodes(min(budget, self.cfg.max_seqs),
                                       tokens, slots, positions, emit)
        self._admit_queued()
        nd = 0 if n_dec == 0 else next(b for b in self._dec_buckets
                                       if b >= n_dec)

        chunks, nt = self._plan_prefill_tiles(nd, budget)
        sched = 0
        for seq, tile0, take in chunks:
            start = nd + tile0 * ct
            tokens[start:start + take] = seq.prompt[seq.pos:seq.pos + take]
            slots[start:start + take] = seq.slot
            positions[start:start + take] = np.arange(
                seq.pos, seq.pos + take, dtype=np.int32)
            seq.pos += take
            sched += take
            if seq.pos == len(seq.prompt):
                emit.append((start + take - 1, seq))
        self._deadlock_guard(n_dec + sched)
        total = nd + nt * ct
        # per-tile metadata (pad tiles: scratch row, valid=0)
        ts = np.full(max(nt, 1), self.cfg.max_seqs, np.int32)
        tp = np.zeros(max(nt, 1), np.int32)
        tv = np.zeros(max(nt, 1), np.int32)
        for seq, tile0, take in chunks:
            pos0 = positions[nd + tile0 * ct]
            for t in range(-(-take // ct)):
                ts[tile0 + t] = seq.slot
                tp[tile0 + t] = pos0 + t * ct
                tv[tile0 + t] = min(ct, take - t * ct)

        self.tokens_scheduled += n_dec + sched
        self.tokens_padded += total - n_dec - sched

        max_pos = int(positions[:total].max(initial=0)) if total else 0
        logits, self.cache = self.spec.ragged_forward_fn(
            self.params, self._h2d(tokens[:total]), self._h2d(slots[:total]),
            self._h2d(positions[:total]), self._h2d(self._table_view(max_pos)),
            self.cache,
            prefill_tiles=(nd, self._h2d(ts), self._h2d(tp), self._h2d(tv), ct))
        self._note_dispatch(t0)
        return self._emit_tokens(logits, emit)

    # ----------------------------------------------------- decode run-ahead
    def _decode_steps(self, k: int, toks, slots, positions, bt) -> torch.Tensor:
        """K greedy decode steps over the paged cache, the next token fed
        back on the device: ``[K, T]`` tokens. Pad rows (slot ``max_seqs``)
        keep position 0, so their KV writes and reads stay in scratch block
        0 and no gather leaves the table (the JAX engine clamps instead)."""
        fwd = self.spec.ragged_forward_fn
        real = slots != self.cfg.max_seqs
        outs = []
        for _ in range(k):
            logits, _ = fwd(self.params, toks, slots, torch.where(real, positions, 0), bt,
                            self.cache)
            toks = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            outs.append(toks)
            positions = positions + 1
        return torch.stack(outs)

    def _run_ahead_k(self, seqs, rem: int) -> int:
        """The run-ahead depth for ``seqs`` (0: none): at most
        ``decode_run_ahead`` (the admission cap while an unadmittable request
        waits with a slot free) and ``rem``, shrunk until the pool covers K
        more tokens of every sequence, then rounded down to a power of two."""
        k_max = self.cfg.decode_run_ahead
        if k_max < 2 or not seqs or any(not s.in_decode for s in seqs):
            return 0
        if self._queued and self._free_slots:
            k_max = min(k_max, self.cfg.run_ahead_admission_cap)
        k = min(k_max, rem)
        while k >= 2 and not all(self._ensure_capacity(s, s.pos + k) for s in seqs):
            k -= 1  # pool pressure: partial growth is kept, retry smaller
        if k < 2:
            return 0
        return 1 << (k.bit_length() - 1)

    def _try_decode_run_ahead(self) -> dict | None:
        """Host-staged run-ahead: when every running sequence decodes, K
        greedy steps in one dispatch, read back at once. Returns the emit
        dict, or None to fall back to one SplitFuse step. Only the arrays a
        greedy chunk reads are staged (the JAX engine also stages its
        sampling planes)."""
        seqs = list(self._running.values())
        k = self._run_ahead_k(
            seqs, min((s.max_new_tokens - len(s.generated) for s in seqs), default=0))
        if not k:
            return None
        t0 = time.perf_counter()
        t = len(seqs)
        bucket = next(b for b in self._buckets if b >= t)
        tokens = np.zeros(bucket, np.int32)
        slots = np.full(bucket, self.cfg.max_seqs, np.int32)
        positions = np.zeros(bucket, np.int32)
        for j, s in enumerate(seqs):
            tokens[j] = s.token_at(s.pos)
            slots[j] = s.slot
            positions[j] = s.pos
        max_pos = max(s.pos + k - 1 for s in seqs)
        out = self._decode_steps(k, self._h2d(tokens), self._h2d(slots), self._h2d(positions),
                                 self._h2d(self._table_view(max_pos)))
        self._note_dispatch(t0, k)
        t1 = time.perf_counter()
        out = out.cpu().numpy()  # [K, bucket]
        self.readback_ns += int((time.perf_counter() - t1) * 1e9)
        self.tokens_scheduled += k * t
        self.tokens_padded += k * (bucket - t)
        self.run_ahead_dispatches += 1
        self.run_ahead_tokens += k * t
        emit: dict = {}
        for j, s in enumerate(seqs):
            for i in range(k):
                tok = int(out[i, j])
                s.generated.append(tok)
                s.pos += 1
                emit[s.uid] = tok
                if s.finished:
                    break  # tokens past EOS stay in the pool; freed on release
            if s.finished:
                self._release(s)
        return emit

    # ------------------------------------------- device-resident dispatch
    def _host(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array to upload from: pinned on the card, so the
        upload does not block the host (the caching host allocator keeps the
        pinned block until the copy has run)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        return src.pin_memory() if self._on_card else src.clone()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without blocking the host."""
        return self._host(arr).to(self.device, non_blocking=True)

    def _write_slot_row(self, seq: _SeqState) -> None:
        """Admission: write one slot's persistent device row in place. The
        last token is 0 until the prompt-completing dispatch picks one (a
        sequence admitted past its prompt feeds its token at ``pos``)."""
        tok = seq.token_at(seq.pos) if seq.pos >= len(seq.prompt) else 0
        # greedy only: seed 0, top-k 0, temperature 0, top-p 1
        iv = np.asarray([tok, seq.pos, 0, len(seq.prompt), 0], np.int32)
        fv = np.asarray([0.0, 1.0], np.float32)
        self.h2d_bytes += iv.nbytes + fv.nbytes + 4  # and the row index
        ivd, fvd = self._upload(iv), self._upload(fv)
        tok_st, pos_st, seed_st, plen_st, temp_st, topk_st, topp_st = self._dev_state
        for st, val in ((tok_st, ivd[0]), (pos_st, ivd[1]), (seed_st, ivd[2]),
                        (plen_st, ivd[3]), (topk_st, ivd[4]), (temp_st, fvd[0]),
                        (topp_st, fvd[1])):
            st[seq.slot].copy_(val)
        self._hist_stale[seq.slot] = True

    def _sync_bt(self) -> bool:
        """Delta-upload the block-table rows dirtied since the last dispatch
        into the device table, in place; the row count is bucketed to a
        power of two, padding rows rewrite the all-zero scratch row. Returns
        whether any row was dirty."""
        if not self._bt_dirty:
            return False
        rows = sorted(self._bt_dirty)
        self._bt_dirty.clear()
        r = 1
        while r < len(rows):
            r *= 2
        idx = np.full(r, self.cfg.max_seqs, np.int32)
        idx[:len(rows)] = rows
        vals = np.zeros((r, self.cfg.max_blocks_per_seq), np.int32)
        vals[:len(rows)] = self.block_tables[rows]
        self.h2d_bytes += idx.nbytes + vals.nbytes
        self._bt_dev[self._upload(idx).long()] = self._upload(vals)
        return True

    def _stage(self, arr: np.ndarray, account: bool = True) -> torch.Tensor:
        """The dispatch's packed int32 staging buffer: one tensor per staged
        length, which the programs (and their graphs) read in place. Its
        bytes are uploaded only when they differ from what it holds: steady
        decode, whose slot and flag planes repeat, uploads nothing.
        ``account=False``: ``warmup()``'s scratch contents, which are no
        dispatch's and count in no byte total."""
        arr = np.ascontiguousarray(arr, np.int32)
        raw = arr.tobytes()
        entry = self._staging.get(arr.shape[0])
        if entry is None:
            entry = self._staging[arr.shape[0]] = [
                None, torch.zeros(arr.shape[0], dtype=torch.int32, device=self.device)]
        if entry[0] != raw:
            entry[1].copy_(self._host(arr), non_blocking=True)
            entry[0] = raw
            if account:
                self.h2d_bytes += arr.nbytes
                self.stage_bytes += arr.nbytes
        return entry[1]

    def _readback(self, out: torch.Tensor):
        """Start copying a dispatch's tokens to the host, in stream order
        right behind the dispatch: a graph's output is overwritten by its
        next replay, which the window of dispatches (two, or
        ``pipeline_depth`` fused chunks) enqueues before this one is
        reconciled. Returns (host tensor, event or None)."""
        if not self._on_card:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _note_steady(self, decode_only: bool, dirty: bool, batch, h2d0: int,
                     stage0: int) -> None:
        """Steady-decode accounting of a device dispatch (see __init__);
        ``batch``: the staged length and the slots of the dispatch."""
        steady = decode_only and batch == self._last_batch
        self._last_batch = batch if decode_only else None
        if steady:
            self.steady_dispatches += 1
            self.steady_stage_bytes += self.stage_bytes - stage0
            if not dirty:
                self.steady_clean_dispatches += 1
                self.steady_h2d_bytes += self.h2d_bytes - h2d0

    def _get_dev_step(self, t: int, nd: int, nt: int, w: int, staged: torch.Tensor):
        """Device-resident SplitFuse step (plain or tiled) over ``staged``
        (tokens | slots | positions | flags, then the tile planes): decode
        rows (flag bit 0) take their token and position from the slot rows;
        the greedy pick is taken on the device; the slot rows are updated in
        place (the picked token where flag bit 1 is set, the position by a
        max-scatter). Returns the program; its output is the picked
        ``[t]`` tokens."""
        fwd = self.spec.ragged_forward_fn
        ct = self.cfg.prefill_tile if self._use_tiles else 0
        max_seqs = self.cfg.max_seqs
        ntl = max(nt, 1)
        tok_st, pos_st = self._dev_state[0], self._dev_state[1]
        bt = self._bt_dev[:, :w] if w < self._bt_dev.shape[1] else self._bt_dev

        def step_fn():
            tokens, slots = staged[0:t], staged[t:2 * t]
            positions, flags = staged[2 * t:3 * t], staged[3 * t:4 * t]
            feed = (flags & 1) > 0
            real = slots != max_seqs
            sl = slots.long()
            tokens = torch.where(feed, tok_st[sl], tokens)
            positions = torch.where(feed & real, pos_st[sl], positions)
            tiles = None
            if ct:
                tiles = (nd, staged[4 * t:4 * t + ntl], staged[4 * t + ntl:4 * t + 2 * ntl],
                         staged[4 * t + 2 * ntl:4 * t + 3 * ntl], ct)
            logits, _ = fwd(self.params, tokens, slots, positions, bt, self.cache,
                            prefill_tiles=tiles)
            picked = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            em = ((flags & 2) > 0) & real
            sl_t = torch.where(em, slots, max_seqs).long()
            tok_st.index_put_((sl_t,), torch.where(em, picked, tok_st[sl_t]))
            sl_p = torch.where(real, slots, max_seqs).long()
            pos_st.scatter_reduce_(0, sl_p, torch.where(real, positions + 1, 0), "amax")
            return picked

        return step_fn

    def _get_dev_chunk(self, k: int, t: int, w: int, staged: torch.Tensor):
        """Device-resident run-ahead: K greedy decode steps whose feed token
        and start position come from the slot rows; ``staged`` holds only
        the slot ids. Afterwards each real slot's token row holds its last
        pick and its position row has advanced by K. Output: ``[K, t]``."""
        max_seqs = self.cfg.max_seqs
        tok_st, pos_st = self._dev_state[0], self._dev_state[1]
        bt = self._bt_dev[:, :w] if w < self._bt_dev.shape[1] else self._bt_dev

        def chunk_fn():
            slots = staged[:t]
            real = slots != max_seqs
            sl = torch.where(real, slots, max_seqs).long()
            out = self._decode_steps(k, tok_st[sl], slots, torch.where(real, pos_st[sl], 0), bt)
            tok_st.index_put_((sl,), torch.where(real, out[-1], tok_st[sl]))
            pos_st.index_add_(0, sl, torch.where(real, k, 0).to(torch.int32))
            return out

        return chunk_fn

    def _dispatch_chunk_device(self) -> bool:
        """Device-state run-ahead: the same eligibility and capacity rules as
        the host-staged one (the budget counted from ``pos``, which runs
        ahead of ``generated`` by the pending window), only the slot ids
        staged, and the tokens left in a pending record."""
        cfg = self.cfg
        seqs = [s for s in self._running.values() if not s.finished]
        k = self._run_ahead_k(
            seqs, min((len(s.prompt) + s.max_new_tokens - s.pos for s in seqs), default=0))
        if not k:
            return False
        t0 = time.perf_counter()
        h2d0, stage0 = self.h2d_bytes, self.stage_bytes
        t = len(seqs)
        bucket = next(b for b in self._buckets if b >= t)
        slots = np.full(bucket, cfg.max_seqs, np.int32)
        for j, s in enumerate(seqs):
            slots[j] = s.slot
        max_pos = max(s.pos + k - 1 for s in seqs)
        dirty = self._sync_bt()
        staged = self._stage(slots)
        w = self._table_width(max_pos)
        out = self.programs.run(("chunk", k, bucket, w),
                                self._get_dev_chunk(k, bucket, w, staged))
        emits = []
        for s in seqs:
            s.pos += k
            s.refs += 1
            self._slot_feed[s.slot] = True
            self._hist_stale[s.slot] = True
            emits.append((s, k))
        self.tokens_scheduled += k * t
        self.tokens_padded += k * (bucket - t)
        self.run_ahead_dispatches += 1
        self.run_ahead_tokens += k * t
        self._pending.append({"kind": "chunk", "out": self._readback(out), "emits": emits,
                              "participants": seqs})
        self._note_dispatch(t0, k)
        self._note_steady(True, dirty, (bucket, tuple(slots)), h2d0, stage0)
        return True

    # ------------------------------------- device-side multi-step scheduler
    def _get_dev_sched(self, k: int, t: int, w: int, staged: torch.Tensor) -> LoopProgram:
        """Multi-step decode scheduler with device-side retirement (and,
        with ``spec_draft``, self-speculation): up to ``k`` decode
        iterations over the rows in ``staged`` (``[slots | eos | limit]``,
        ``limit`` the last feed position, ``prompt_len + max_new - 1``, so
        steady decode stages the same bytes and uploads nothing). Feed token
        and position come from the slot rows; each row's budget is
        min(k, limit - pos), derived on the device. A row retires on its EOS
        or its budget and then runs on the scratch slot; the loop ends when
        every row has retired. A row the host re-dispatched after the device
        picked its EOS (a dispatch not yet read back) finds that EOS in its
        token row and takes no step.

        With ``spec_draft`` D each iteration drafts D tokens a row from the
        token history (``propose_ngram_drafts``), lays them out as verify
        lanes (``speculative_lane_layout``), runs one forward over t (1+D)
        tokens and surfaces the accepted prefix plus the model's own next
        pick (``accept_drafts``), appending what it surfaces to the history.

        A ``LoopProgram`` whose carry (tokens, positions, emitted counts,
        retired flags, the output rows, the counts) lives in buffers made
        here, which every iteration updates in place. Its output packs
        ``[k, t]`` tokens (-1 where none), each row's steps taken ``[t]``,
        then the drafted and accepted counts and the iterations run."""
        # the program refers to the engine's tensors, not to the engine: the
        # engine keeps its programs, so a reference back would be a cycle
        # that holds the parameters after the engine is dropped
        fwd, params, cache = self.spec.ragged_forward_fn, self.params, self.cache
        max_seqs, d, ngram = self.cfg.max_seqs, self.cfg.spec_draft, self.cfg.spec_ngram
        lanes = 1 + d
        tok_st, pos_st = self._dev_state[0], self._dev_state[1]
        hist = self._hist_dev
        bt = self._bt_dev[:, :w] if w < self._bt_dev.shape[1] else self._bt_dev
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        slots, eos, limit = staged[:t], staged[t:2 * t], staged[2 * t:3 * t]
        toks, pos, emitted, bud, cap = (torch.zeros(t, **i32) for _ in range(5))
        real, done = (torch.zeros(t, dtype=torch.bool, device=dev) for _ in range(2))
        out = torch.full((k + 1, t), -1, **i32)  # row k takes the lanes not surfaced
        counts = torch.zeros(3, **i32)  # drafted, accepted, iterations
        pred = torch.zeros((), dtype=torch.bool, device=dev)
        lane_i = torch.arange(lanes, device=dev)[None, :]
        col_i = torch.arange(t, device=dev)[:, None].expand(t, lanes)
        no_draft = torch.zeros((t, 0), **i32)

        def prologue():
            sl = slots.long()
            real.copy_(slots != max_seqs)
            toks.copy_(tok_st[sl])
            pos.copy_(torch.where(real, pos_st[sl], 0))
            # the host holds KV blocks for min(k, limit - pos) feeds of each
            # row: cap is the first position without one
            bud.copy_(torch.where(real, torch.clamp(limit - pos, 0, k), 0))
            cap.copy_(pos + bud)
            done.copy_(~real | (bud <= 0) | ((eos >= 0) & (toks == eos)))
            emitted.zero_()
            out.fill_(-1)
            counts.zero_()
            pred.copy_((~done).any())

        def body():
            live = ~done
            draft = propose_ngram_drafts(hist[slots.long()], pos, ngram, d)[0] if d else None
            ftok, fslot, fpos, _ = speculative_lane_layout(toks, draft, pos, live, cap, slots,
                                                           max_seqs)
            logits, _ = fwd(params, ftok, fslot, fpos, bt, cache)
            picked = torch.argmax(logits.float(), dim=-1).to(torch.int32).reshape(t, lanes)
            n_emit, n_acc = accept_drafts(no_draft if draft is None else draft, picked,
                                          torch.where(live, bud - emitted, 0), eos)
            sel = lane_i < n_emit[:, None]
            # surfaced token i lands in out row emitted + i, the rest in row k
            out.index_put_((torch.where(sel, emitted[:, None] + lane_i, k).long(), col_i),
                           picked)
            if d:  # surfaced token i is the token at position pos + 1 + i
                hist.index_put_((torch.where(sel, slots[:, None], max_seqs).long(),
                                 torch.where(sel, pos[:, None] + 1 + lane_i, 0).long()), picked)
            last = torch.gather(picked, 1, torch.clamp(n_emit - 1, 0, lanes - 1).long()[:, None])
            last = last[:, 0]
            toks.copy_(torch.where(n_emit > 0, last, toks))
            pos.add_(n_emit)
            emitted.add_(n_emit)
            done.copy_(done | ((eos >= 0) & (last == eos) & (n_emit > 0)) | (emitted >= bud))
            counts[:2].add_(torch.stack([torch.where(live, d, 0).sum(), n_acc.sum()])
                            .to(torch.int32))
            counts[2:].add_(1)
            pred.copy_((~done).any())

        def epilogue():
            sl = torch.where(real, slots, max_seqs).long()
            tok_st.index_put_((sl,), torch.where(real, toks, tok_st[sl]))
            pos_st.index_put_((sl,), torch.where(real, pos, pos_st[sl]))
            return torch.cat([out[:k].reshape(-1), emitted, counts])

        return LoopProgram(prologue, body, epilogue, pred, k)

    def _sched_program(self, k: int, t: int, w: int, staged: torch.Tensor):
        """(key, program) of the scheduler program ``(k, t, w)``, made once:
        its carry buffers and its staging buffer persist, so the program
        (and on the card its graph) serves every dispatch of the key."""
        key = ("sched", k, t, w, self.cfg.spec_draft)
        prog = self._sched_programs.get(key)
        if prog is None:
            prog = self._sched_programs[key] = self._get_dev_sched(k, t, w, staged)
        return key, prog

    def _upload_hist(self, seq: _SeqState) -> None:
        """Write one slot's history row anew from the host's complete view
        (prompt + generated). Only when the slot has no dispatch in flight:
        otherwise ``generated`` lags the device's position and the row would
        hold a hole where the draft matcher reads."""
        row = np.zeros(self.cfg.max_seq_len, np.int32)
        toks = seq.prompt + seq.generated
        row[:len(toks)] = toks
        self.h2d_bytes += row.nbytes + 4  # and the row index
        self._hist_dev[seq.slot].copy_(self._upload(row))
        self._hist_stale[seq.slot] = False

    def _dispatch_sched_device(self) -> bool:
        """Dispatch one scheduler program when every running sequence
        decodes. The eligibility and admission rules of run-ahead, but each
        row is budgeted on its own (a row near its length limit no longer
        caps the chunk: the program retires it in place): k is the deepest
        budget rounded DOWN to a power of two (the device derives each
        row's steps as min(k, limit - pos), so k must not pass the capacity
        reserved here), capped under admission pressure; a row whose blocks
        cannot be reserved is preempted. Host positions advance by each
        row's budget at once (an EOS retires the sequence at reconcile,
        whatever it overshot), and the tokens, steps taken and counts are
        left in a pending record."""
        cfg = self.cfg
        k_max = cfg.sched_steps
        seqs = [s for s in self._running.values() if not s.finished]
        if not seqs or any(not s.in_decode for s in seqs):
            return False
        if self._queued and self._free_slots:
            k_max = min(k_max, cfg.run_ahead_admission_cap)
            if k_max < 1:
                return False
        plan, max_bud = [], 0
        for s in seqs:
            bud = len(s.prompt) + s.max_new_tokens - 1 - s.pos
            if bud <= 0:
                continue  # fully scheduled; retires as its dispatches reconcile
            plan.append(s)
            max_bud = max(max_bud, min(bud, k_max))
        if not plan:
            return False
        k = 1 << (max_bud.bit_length() - 1)
        kept = []
        for s in plan:
            k_s = min(k, len(s.prompt) + s.max_new_tokens - 1 - s.pos)
            if not self._ensure_capacity(s, s.pos + k_s):
                s.preemptions += 1
                self.preemptions += 1
                continue
            kept.append((s, k_s))
        if not kept:
            return False
        h2d0, stage0 = self.h2d_bytes, self.stage_bytes
        if cfg.spec_draft:
            stale = [s for s, _ in kept if self._hist_stale[s.slot]]
            if any(s.refs for s in stale):
                self._sched_wait = True
                return False
            for s in stale:
                self._upload_hist(s)
        t0 = time.perf_counter()
        t = len(kept)
        bucket = next(b for b in self._buckets if b >= t)
        slots = np.full(bucket, cfg.max_seqs, np.int32)
        eos = np.full(bucket, -1, np.int32)
        limit = np.zeros(bucket, np.int32)
        max_pos = 0
        for j, (s, k_s) in enumerate(kept):
            slots[j] = s.slot
            if s.eos_token_id is not None:
                eos[j] = s.eos_token_id
            limit[j] = len(s.prompt) + s.max_new_tokens - 1
            max_pos = max(max_pos, s.pos + k_s - 1)
        dirty = self._sync_bt()
        staged = self._stage(np.concatenate([slots, eos, limit]))
        w = self._table_width(max_pos)
        out, per_iteration = self.programs.run_loop(*self._sched_program(k, bucket, w, staged))
        emits = []
        for s, k_s in kept:
            s.pos += k_s
            s.refs += 1
            self._slot_feed[s.slot] = True
            emits.append((s, k_s))
        sched_tok = sum(k_s for _, k_s in kept)
        self.tokens_scheduled += sched_tok
        self.tokens_padded += k * bucket - sched_tok
        self.sched_dispatches += 1
        self._pending.append({"kind": "sched", "out": self._readback(out), "emits": emits,
                              "participants": [s for s, _ in kept], "k": k, "t": bucket,
                              "per_iteration": per_iteration})
        self._note_dispatch(t0, 0)  # its forwards are counted at reconcile
        self._note_steady(True, dirty, (staged.shape[0], tuple(slots)), h2d0, stage0)
        return True

    def _dispatch_step_device(self) -> bool:
        """Device-state SplitFuse step: decodes and prefill chunks scheduled
        as the host-staged path schedules them, staged as one packed buffer
        (decode rows carry no token or position: those live on the device),
        the picked tokens left in a pending record. False when nothing is
        schedulable."""
        cfg = self.cfg
        ct = cfg.prefill_tile if self._use_tiles else 0
        budget = cfg.max_tokens_per_step
        t0 = time.perf_counter()
        h2d0, stage0 = self.h2d_bytes, self.stage_bytes
        size = budget + ct
        tokens = np.zeros(size, np.int32)
        slots = np.full(size, cfg.max_seqs, np.int32)
        positions = np.zeros(size, np.int32)
        flags = np.zeros(size, np.int32)
        emit: list[tuple[int, _SeqState]] = []
        max_pos = 0
        dec_cap = min(budget, cfg.max_seqs) if ct else budget
        n_dec = 0
        for seq in list(self._running.values()):
            if seq.finished or not seq.in_decode or n_dec >= dec_cap:
                continue
            # the feed at limit - 1 yields the last budgeted token; with the
            # scheduler on that is the bound, otherwise one more may be
            # scheduled and is discarded at reconcile (the JAX engine's slop)
            lim = len(seq.prompt) + seq.max_new_tokens - (cfg.sched_steps >= 2)
            if seq.pos >= lim:
                continue  # fully scheduled; retires as its dispatches reconcile
            if not self._ensure_capacity(seq, seq.pos + 1):
                seq.preemptions += 1
                self.preemptions += 1
                continue
            slots[n_dec] = seq.slot
            flags[n_dec] = 3  # token and position from the slot rows | emit
            emit.append((n_dec, seq))
            max_pos = max(max_pos, seq.pos)
            seq.pos += 1
            n_dec += 1

        ts = tpz = tv = None
        if ct:
            nd = 0 if n_dec == 0 else next(b for b in self._dec_buckets if b >= n_dec)
            chunks, nt = self._plan_prefill_tiles(nd, budget)
            ts = np.full(max(nt, 1), cfg.max_seqs, np.int32)
            tpz = np.zeros(max(nt, 1), np.int32)
            tv = np.zeros(max(nt, 1), np.int32)
            sched = 0
            for seq, tile0, take in chunks:
                start = nd + tile0 * ct
                sl = slice(start, start + take)
                tokens[sl] = seq.prompt[seq.pos:seq.pos + take]
                slots[sl] = seq.slot
                positions[sl] = np.arange(seq.pos, seq.pos + take, dtype=np.int32)
                self._tile_meta(ts, tpz, tv, tile0, seq, take)
                max_pos = max(max_pos, seq.pos + take - 1)
                seq.pos += take
                sched += take
                if seq.pos == len(seq.prompt):
                    flags[start + take - 1] |= 2
                    emit.append((start + take - 1, seq))
                    self._slot_feed[seq.slot] = True
            n = n_dec + sched
            t_total = nd + nt * ct
        else:
            nd = nt = 0
            n = n_dec
            for seq in list(self._running.values()):
                if seq.finished or seq.in_decode or n >= budget:
                    continue
                take = min(budget - n, len(seq.prompt) - seq.pos)
                while take and not self._ensure_capacity(seq, seq.pos + take):
                    take -= 1  # partial chunk under pool pressure
                if take <= 0:
                    continue
                sl = slice(n, n + take)
                tokens[sl] = seq.prompt[seq.pos:seq.pos + take]
                slots[sl] = seq.slot
                positions[sl] = np.arange(seq.pos, seq.pos + take, dtype=np.int32)
                max_pos = max(max_pos, seq.pos + take - 1)
                seq.pos += take
                n += take
                if seq.pos == len(seq.prompt):
                    flags[n - 1] |= 2
                    emit.append((n - 1, seq))
                    self._slot_feed[seq.slot] = True
            t_total = 0 if n == 0 else next(b for b in self._buckets if b >= n)
        if n == 0:
            return False
        self.tokens_scheduled += n
        self.tokens_padded += t_total - n
        parts = [tokens[:t_total], slots[:t_total], positions[:t_total], flags[:t_total]]
        if ct:
            parts += [ts, tpz, tv]
        dirty = self._sync_bt()
        staged = self._stage(np.concatenate(parts))
        w = self._table_width(max_pos)
        decode_only = n == n_dec
        # decode-only steps replay as graphs; steps with prefill run eagerly
        picked = self.programs.run(("step", t_total, nd, nt, w),
                                   self._get_dev_step(t_total, nd, nt, w, staged),
                                   capture=decode_only)
        participants = list({seq.slot: seq for _, seq in emit}.values())
        for seq in participants:
            seq.refs += 1
            self._hist_stale[seq.slot] = True
        self._pending.append({"kind": "step", "out": self._readback(picked), "emit": emit,
                              "participants": participants})
        self._note_dispatch(t0)
        self._note_steady(decode_only, dirty, (staged.shape[0], tuple(slots[:t_total])), h2d0,
                          stage0)
        return True

    def _append_tokens(self, seq: _SeqState, toks, out: dict) -> None:
        """Fold a dispatch's tokens into ``seq``; tokens past its EOS or its
        budget (scheduled ahead before the readback showed the end) are
        discarded."""
        for t in toks:
            if seq.finished:
                break
            seq.generated.append(int(t))
            out[seq.uid] = int(t)

    def _read(self, out) -> np.ndarray:
        """A dispatch's tokens on the host, once its readback (``_readback``)
        has landed."""
        t0 = time.perf_counter()
        host, event = out
        if event is not None:
            event.synchronize()
        toks = host.cpu().numpy()
        self.readback_ns += int((time.perf_counter() - t0) * 1e9)
        return toks

    def _drop_refs(self, participants) -> None:
        """A reconciled dispatch's references: release each participant whose
        last one this was and which has finished."""
        for seq in participants:
            seq.refs -= 1
            if seq.finished and seq.refs == 0 and seq.slot >= 0:
                self._release(seq)

    def _reconcile_pending(self) -> dict:
        """Read back the oldest pending dispatch's tokens, fold them into
        host state and release each participant whose last pending
        reference this was and which has finished."""
        rec = self._pending.pop(0)
        toks = self._read(rec["out"])
        out: dict = {}
        if rec["kind"] == "step":
            for row, seq in rec["emit"]:
                self._append_tokens(seq, [int(toks[row])], out)
        elif rec["kind"] == "sched":
            # [K, bucket] tokens | steps taken [bucket] | proposed | accepted
            # | iterations
            k, t = rec["k"], rec["t"]
            steps = toks[k * t:k * t + t]
            proposed, accepted, iterations = (int(x) for x in toks[-3:])
            for j, (seq, _) in enumerate(rec["emits"]):
                if steps[j]:
                    self._append_tokens(seq, toks[j:k * t:t][:steps[j]], out)
            if self.cfg.spec_draft:
                self.spec_proposed += proposed
                self.spec_accepted += accepted
            self.forwards += iterations
            self.sched_iterations += iterations
            if rec["per_iteration"] is not None:
                self.programs.add_iterations(rec["per_iteration"], iterations)
        else:  # chunk: [K, bucket]
            for j, (seq, k) in enumerate(rec["emits"]):
                self._append_tokens(seq, toks[:k, j], out)
        self._drop_refs(rec["participants"])
        return out

    def _step_device(self) -> dict:
        """One device-resident turn: admit, dispatch a scheduler program, or
        else (unless it waits for stale history rows) a run-ahead chunk or a
        step, if anything is schedulable; then reconcile the oldest pending
        dispatch once the window holds two (or nothing was dispatched), so
        the readback of dispatch t overlaps the card running t + 1."""
        self._admit_queued()
        dispatched = False
        self._sched_wait = False
        if self.cfg.sched_steps >= 2:
            dispatched = self._dispatch_sched_device()
        if not dispatched and not self._sched_wait:
            if self.cfg.decode_run_ahead >= 2:
                dispatched = self._dispatch_chunk_device()
            if not dispatched:
                dispatched = self._dispatch_step_device()
        if self._pending and (not dispatched or len(self._pending) >= 2):
            return self._reconcile_pending()
        if not dispatched and not self._pending and (self._queued or self._running):
            self._deadlock_guard(0)
        return {}

    # ------------------------------------------------- fused mixed chunks
    def _fused_scan(self, k: int, nd: int, tok0, slots, positions, dec_rem, eos_ids, done0,
                    bt):
        """Steps 1 .. k - 1 of a fused chunk over its decode region [0, nd):
        row j runs its first ``dec_rem[j]`` steps, fed its previous pick,
        until it picks its EOS. A frozen row (its steps used up) or a retired
        one (EOS picked, or ``done0``: its feed was already its EOS) runs on
        the scratch slot at position 0, writing no real state, keeps its
        last token and surfaces -1. Returns ``[k, nd]`` tokens (step 0's
        picks first, -1 for ``done0`` rows) and each row's final carry."""
        fwd, max_seqs = self.spec.ragged_forward_fn, self.cfg.max_seqs
        eosd = eos_ids[:nd]
        has_eos = eosd >= 0
        dec_slots = slots[:nd]
        toks = tok0[:nd]
        outs = [torch.where(done0, -1, toks)]
        done = done0 | ((toks == eosd) & has_eos)
        pos = positions[:nd] + 1
        for i in range(1, k):
            active = (i < dec_rem) & ~done
            s = torch.where(active, dec_slots, max_seqs)
            p = torch.where(active, pos, 0)
            logits, _ = fwd(self.params, toks, s, p, bt, self.cache)
            nxt = torch.where(active, torch.argmax(logits.float(), dim=-1).to(torch.int32), toks)
            done = done | (active & (nxt == eosd) & has_eos)
            outs.append(torch.where(active, nxt, -1))
            toks = nxt
            pos = pos + 1
        return torch.stack(outs), toks

    def _get_fused_chunk(self, k: int, nd: int, nt: int):
        """Host-staged fused chunk: one mixed SplitFuse step over the staged
        rows, then ``_fused_scan`` for the decode region. Rows [0, nd) are
        decodes (``feed_sel`` picks the slot's device token, ``_slot_toks``,
        over the host's), rows [nd, t) prefill chunks (tile-aligned when
        ``nt`` > 0); ``pf_last`` rows complete a prompt and publish their
        first token into ``_slot_toks``, and each decode row's final carry
        goes there too, so the next chunk needs no readback of this one.
        The program's output packs the ``[k, nd]`` decode tokens and step 0's
        ``[t]`` picks into one int32 vector."""
        fwd, max_seqs, ct = self.spec.ragged_forward_fn, self.cfg.max_seqs, self.cfg.prefill_tile

        def chunk_fn(tokens, slots, positions, feed_sel, dec_rem, eos_ids, pf_last, tiles, bt):
            st = self._slot_toks
            t = tokens.shape[0]
            done0 = None
            if nd:
                fed = torch.where(feed_sel > 0, st[slots[:nd].long()], tokens[:nd])
                tokens = torch.cat([fed, tokens[nd:]])
                # entry-case retirement: a chunk dispatched before the host
                # read a row's EOS finds that EOS as its feed; the row runs
                # on the scratch slot for the whole chunk
                done0 = (fed == eos_ids) & (eos_ids >= 0)
                slots = torch.cat([torch.where(done0, max_seqs, slots[:nd]), slots[nd:]])
                positions = torch.cat([torch.where(done0, 0, positions[:nd]), positions[nd:]])
            logits, _ = fwd(self.params, tokens, slots, positions, bt, self.cache,
                            prefill_tiles=(nd, *tiles, ct) if nt else None)
            tok0 = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            if t > nd:
                mask = pf_last[nd:] > 0
                sl_pf = torch.where(mask, slots[nd:], max_seqs).long()
                st.index_put_((sl_pf,), torch.where(mask, tok0[nd:], st[sl_pf]))
            if not nd:
                return tok0
            dec_toks, last = self._fused_scan(k, nd, tok0, slots, positions, dec_rem, eos_ids,
                                              done0, bt)
            st.index_put_((slots[:nd].long(),), last)  # done0 and pad rows: scratch
            return torch.cat([dec_toks.reshape(-1), tok0])

        return chunk_fn

    def _width_ladder(self) -> list[int]:
        """The block-table widths ``_table_width`` can give."""
        mb = self.cfg.max_blocks_per_seq
        if mb <= 64:
            return [mb]
        widths, b = [], 16
        while b < mb:
            widths.append(b)
            b *= 4
        widths.append(mb)
        return widths

    def _fused_family(self):
        """Every fused program ``_dispatch_fused`` can dispatch, as the JAX
        engine's ``_warmup_fused`` enumerates them: ``(k, nd, nt, w, t)`` for
        the scan depths (``fused_chunk`` and each power of two below), the
        all-or-nothing decode region, the tile counts ``_plan_prefill_tiles``
        gives (flat: the token buckets in ``nt``'s place) and the table
        widths; ``t`` is the program's token count."""
        cfg = self.cfg
        ct = cfg.prefill_tile if self._use_tiles else 0
        budget = cfg.max_tokens_per_step
        nd_full = next(b for b in self._dec_buckets if b >= min(cfg.max_seqs, budget))
        ks = {cfg.fused_chunk}
        p = 1
        while p < cfg.fused_chunk:
            ks.add(p)
            p *= 2
        combos = set()
        if ct:
            def nts(cap):
                vals, b = {cap}, 1
                while b <= cap:
                    vals.add(b)
                    b *= 2
                return vals

            combos |= {(1, 0, nt) for nt in nts(max(1, budget // ct))}
            capd = max(1, (budget - nd_full) // ct)
            combos |= {(kk, nd_full, nt) for kk in ks for nt in nts(capd) | {0}}
        else:
            combos |= {(1, 0, b) for b in self._buckets}
            combos |= {(kk, nd_full, b) for kk in ks for b in [0] + self._buckets}
        for kk, nd, nt, w in sorted((*c, w) for c in combos for w in self._width_ladder()):
            t = nd + nt * ct if ct else (nd if nt == 0 else nt)
            if 0 < t and nd <= t <= budget + nd:
                yield kk, nd, nt, w, t

    def warmup(self) -> int:
        """Prepare the program families before serving, the counterpart of
        the JAX engine's ``warmup()``: the fused-chunk family
        (``fused_chunk`` >= 2, each program ``_fused_family`` lists) and, on
        the device-resident path, the scheduler family (``sched_steps`` >=
        2, ``_sched_family``). On the device-resident path each program runs
        once eagerly on an all-scratch staging buffer (every slot
        ``max_seqs``, flags 0, no valid tile row, no live scheduler row: its
        KV writes land in scratch block 0, its slot-row and history writes in
        the scratch rows, so no engine state changes) and, on a CUDA device,
        is captured, so serving replays it from its first dispatch. The
        host-staged path runs its fused programs eagerly and has nothing to
        prepare. Returns the number of programs (a program two combinations
        reach counts twice, as in the JAX engine)."""
        max_seqs = self.cfg.max_seqs
        n = 0
        if self.cfg.fused_chunk >= 2:
            for k, nd, nt, w, t in self._fused_family():
                n += 1
                if not self.cfg.device_state:
                    continue
                nt_prog = nt if self._use_tiles else 0
                ndl, ntl = max(nd, 1), max(nt_prog, 1)
                parts = [np.zeros(t), np.full(t, max_seqs), np.zeros(2 * t), np.zeros(ndl),
                         np.full(ndl, -1)]
                if nt_prog:
                    parts += [np.full(ntl, max_seqs), np.zeros(2 * ntl)]
                staged = self._stage(np.concatenate(parts).astype(np.int32), account=False)
                self.programs.warm(("fused", t, k, nd, nt_prog, w),
                                   self._get_dev_fused(t, k, nd, nt_prog, w, staged))
        if self.cfg.sched_steps >= 2 and self.cfg.device_state:
            for k, t, w in self._sched_family():
                n += 1
                staged = self._stage(np.concatenate(
                    [np.full(t, max_seqs), np.full(t, -1), np.zeros(t)]).astype(np.int32),
                    account=False)
                self.programs.warm(*self._sched_program(k, t, w, staged))
        return n

    def _sched_family(self):
        """Every scheduler program ``_dispatch_sched_device`` can dispatch,
        as the JAX engine's ``_warmup_sched`` enumerates them: ``(k, t, w)``
        for each power of two k up to ``sched_steps``, each token bucket up
        to the one that holds ``max_seqs`` rows, and each table width."""
        ks, p = [], 1
        while p <= self.cfg.sched_steps:
            ks.append(p)
            p *= 2
        bmax = next(b for b in self._buckets if b >= self.cfg.max_seqs)
        return [(k, t, w) for k in ks for t in self._buckets if t <= bmax
                for w in self._width_ladder()]

    def _dispatch_fused(self) -> bool:
        """Schedule and dispatch ONE fused chunk from host state (no
        readback): decode rows first, each for ``k_s`` = min(fused_chunk,
        its remaining budget) steps, in a decode region of all-or-nothing
        size; then prefill chunks after it, flat or tile-aligned; the scan
        depth k the largest ``k_s`` rounded up to a power of two. False when
        nothing is schedulable."""
        self._admit_queued()
        t0 = time.perf_counter()
        cfg = self.cfg
        k_max = cfg.fused_chunk
        ct = cfg.prefill_tile if self._use_tiles else 0
        budget = cfg.max_tokens_per_step
        decs: list[tuple[_SeqState, int]] = []
        for seq in list(self._running.values()):
            if seq.finished or not seq.in_decode:
                continue
            rem = seq.max_new_tokens - (seq.pos - len(seq.prompt))
            if rem <= 0:
                continue
            k_s = min(k_max, rem)
            if not self._ensure_capacity(seq, seq.pos + k_s):
                continue  # admitted sequences cannot hit this (reservation)
            decs.append((seq, k_s))
            if len(decs) >= min(budget, cfg.max_seqs):
                break
        # the decode region is 0 rows or one fixed bucket: every (k, nd, nt,
        # width) is a program of its own, and padded rows ride the scratch slot
        nd = 0 if not decs else next(b for b in self._dec_buckets
                                     if b >= min(cfg.max_seqs, budget))
        chunks: list[tuple[_SeqState, int, int]] = []  # (seq, first row, take)
        if ct:
            tile_chunks, nt = self._plan_prefill_tiles(nd, budget)
            chunks = [(seq, nd + tile0 * ct, take) for seq, tile0, take in tile_chunks]
            t_total = nd + nt * ct
        else:
            nt = 0
            fill = nd
            for seq in list(self._running.values()):
                if seq.finished or seq.in_decode or fill >= budget:
                    continue
                take = min(budget - fill, len(seq.prompt) - seq.pos)
                while take and not self._ensure_capacity(seq, seq.pos + take):
                    take -= 1  # partial chunk under pool pressure
                if take <= 0:
                    continue
                chunks.append((seq, fill, take))
                fill += take
            t_total = nd if fill == nd else next(b for b in self._buckets if b >= fill)
        if not decs and not chunks:
            return False
        k = min(k_max, 1 << (max(ks for _, ks in decs) - 1).bit_length()) if decs else 1
        if cfg.device_state:
            return self._dispatch_fused_device(decs, chunks, nd, nt, k, t_total, t0)

        tokens, slots, positions, dec_rem, eos_row, tiles, pf_done, max_pos = \
            self._fused_rows(decs, chunks, nd, nt, k, t_total)
        feed_sel = np.zeros(max(nd, 1), np.int32)
        for j, (seq, _) in enumerate(decs):
            positions[j] = seq.pos
            if self._slot_feed[seq.slot]:
                feed_sel[j] = 1
            else:
                if seq.pos - len(seq.prompt) >= len(seq.generated):
                    raise RuntimeError(
                        "fused scheduler: host token unavailable and no device feed for "
                        f"uid={seq.uid!r} (pos={seq.pos})")
                tokens[j] = seq.token_at(seq.pos)
        pf_last = np.zeros_like(tokens)
        for row, _ in pf_done:
            pf_last[row] = 1
        packed = self._get_fused_chunk(k, nd, nt)(
            self._h2d(tokens), self._h2d(slots), self._h2d(positions), self._h2d(feed_sel),
            self._h2d(dec_rem), self._h2d(eos_row), self._h2d(pf_last),
            tuple(self._h2d(x) for x in tiles) if nt else None,
            self._h2d(self._table_view(max_pos)))
        self._note_dispatch(t0, 1 + (k - 1) * (nd > 0))
        self._push_chunk(packed, k, nd, decs, chunks, pf_done)
        return True

    def _fused_rows(self, decs, chunks, nd: int, nt: int, k: int, t_total: int):
        """The rows both fused paths stage, and the chunk's token accounting.
        Decode rows [0, len(decs)) carry their slot, step count and EOS (-1:
        none); each prompt chunk its token run at positions from ``seq.pos``
        (which advances past it) and, tiled, its tile planes. Scheduled
        tokens: step 0's real rows and the scan steps each decode row runs;
        padded: the rest of the ``t_total`` + (k - 1) nd rows. Returns
        (tokens, slots, positions, dec_rem, eos, (tile slot, tile position,
        tile valid rows), the (row, seq) of each prompt-completing row, the
        highest position the chunk touches)."""
        cfg = self.cfg
        ct = cfg.prefill_tile if self._use_tiles else 0
        n_rows = max(t_total, 1)
        tokens = np.zeros(n_rows, np.int32)
        slots = np.full(n_rows, cfg.max_seqs, np.int32)
        positions = np.zeros(n_rows, np.int32)
        dec_rem = np.zeros(max(nd, 1), np.int32)
        eos_row = np.full(max(nd, 1), -1, np.int32)
        for j, (seq, k_s) in enumerate(decs):
            slots[j] = seq.slot
            dec_rem[j] = k_s
            if seq.eos_token_id is not None:
                eos_row[j] = seq.eos_token_id
        max_pos = max((seq.pos + k_s - 1 for seq, k_s in decs), default=0)
        ts = np.full(max(nt, 1), cfg.max_seqs, np.int32)
        tpos = np.zeros(max(nt, 1), np.int32)
        tval = np.zeros(max(nt, 1), np.int32)
        pf_done: list[tuple[int, _SeqState]] = []
        for seq, start, take in chunks:
            tokens[start:start + take] = seq.prompt[seq.pos:seq.pos + take]
            slots[start:start + take] = seq.slot
            positions[start:start + take] = np.arange(seq.pos, seq.pos + take, dtype=np.int32)
            if ct:
                self._tile_meta(ts, tpos, tval, (start - nd) // ct, seq, take)
            if seq.pos + take == len(seq.prompt):
                pf_done.append((start + take - 1, seq))
            max_pos = max(max_pos, seq.pos + take - 1)
            seq.pos += take
        n0 = len(decs) + sum(take for _, _, take in chunks)
        active_scan = sum(k_s - 1 for _, k_s in decs)
        self.tokens_scheduled += n0 + active_scan
        self.tokens_padded += (t_total - n0) + (k - 1) * nd - active_scan
        return tokens, slots, positions, dec_rem, eos_row, (ts, tpos, tval), pf_done, max_pos

    def _tile_meta(self, ts, tpos, tval, tile0: int, seq: _SeqState, take: int) -> None:
        """The tile planes of a prompt chunk of ``take`` tokens of ``seq``
        from ``seq.pos``, laid from tile ``tile0``: slot, first position and
        valid rows of each of its tiles."""
        ct = self.cfg.prefill_tile
        for ti in range(-(-take // ct)):
            ts[tile0 + ti] = seq.slot
            tpos[tile0 + ti] = seq.pos + ti * ct
            tval[tile0 + ti] = min(ct, take - ti * ct)

    def _get_dev_fused(self, t: int, k: int, nd: int, nt: int, w: int, staged: torch.Tensor):
        """Device-resident fused chunk over ``staged`` (tokens | slots |
        positions | flags | dec_rem | eos, then the tile planes): the
        program of ``_get_fused_chunk``, with each decode row's feed token
        and position gathered from its slot rows (flag bit 0) and the slot
        rows updated in place: prompt-completing rows (flag bit 1) set their
        token row, prefill rows max-scatter their position, and each decode
        row leaves its final carry and advances by min(dec_rem, k). A
        program of no arguments over persistent tensors, as
        ``_get_dev_step``; its output packs the ``[k, nd]`` decode tokens
        and step 0's ``[t]`` picks."""
        fwd = self.spec.ragged_forward_fn
        ct = self.cfg.prefill_tile if self._use_tiles else 0
        max_seqs = self.cfg.max_seqs
        ndl, ntl = max(nd, 1), max(nt, 1)
        tok_st, pos_st = self._dev_state[0], self._dev_state[1]
        bt = self._bt_dev[:, :w] if w < self._bt_dev.shape[1] else self._bt_dev
        b = 4 * t + 2 * ndl  # start of the tile planes

        def fused_fn():
            slots, positions, flags = staged[t:2 * t], staged[2 * t:3 * t], staged[3 * t:4 * t]
            dec_rem, eos_ids = staged[4 * t:4 * t + ndl], staged[4 * t + ndl:b]
            feed = (flags & 1) > 0
            sl = slots.long()
            # decode rows feed the token their slot row holds
            tokens = torch.where(feed, tok_st[sl], staged[0:t])
            positions = torch.where(feed & (slots != max_seqs), pos_st[sl], positions)
            done0 = None
            if nd:
                done0 = (tokens[:nd] == eos_ids[:nd]) & (eos_ids[:nd] >= 0)
                slots = torch.cat([torch.where(done0, max_seqs, slots[:nd]), slots[nd:]])
                positions = torch.cat([torch.where(done0, 0, positions[:nd]), positions[nd:]])
            real = slots != max_seqs
            tiles = None
            if nt:
                tiles = (nd, staged[b:b + ntl], staged[b + ntl:b + 2 * ntl],
                         staged[b + 2 * ntl:b + 3 * ntl], ct)
            logits, _ = fwd(self.params, tokens, slots, positions, bt, self.cache,
                            prefill_tiles=tiles)
            tok0 = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            if t > nd:
                mask = (flags[nd:] & 2) > 0
                sl_pf = torch.where(mask, slots[nd:], max_seqs).long()
                tok_st.index_put_((sl_pf,), torch.where(mask, tok0[nd:], tok_st[sl_pf]))
                sl_p = torch.where(real[nd:], slots[nd:], max_seqs).long()
                pos_st.scatter_reduce_(0, sl_p, torch.where(real[nd:], positions[nd:] + 1, 0),
                                       "amax")
            if not nd:
                return tok0
            dec_toks, last = self._fused_scan(k, nd, tok0, slots, positions, dec_rem, eos_ids,
                                              done0, bt)
            rd = real[:nd]  # done0 rows are on the scratch slot already
            sl_d = torch.where(rd, slots[:nd], max_seqs).long()
            tok_st.index_put_((sl_d,), torch.where(rd, last, tok_st[sl_d]))
            pos_st.index_add_(0, sl_d, torch.where(rd, torch.clamp(dec_rem, max=k), 0))
            return torch.cat([dec_toks.reshape(-1), tok0])

        return fused_fn

    def _dispatch_fused_device(self, decs, chunks, nd: int, nt: int, k: int, t_total: int,
                               t0: float) -> bool:
        """Stage and dispatch one fused chunk against the device-resident slot
        rows: decode rows carry only their slot, feed flag, step count and
        EOS (token and position are on the device), prefill rows their
        token runs, in ONE packed buffer that byte-compares equal across
        steady decode chunks. Every program goes through the program cache,
        mixed ones too, so on the card each replays as a CUDA graph."""
        h2d0, stage0 = self.h2d_bytes, self.stage_bytes
        tokens, slots, positions, dec_rem, eos_row, tiles, pf_done, max_pos = \
            self._fused_rows(decs, chunks, nd, nt, k, t_total)
        flags = np.zeros_like(tokens)
        flags[:len(decs)] = 1  # token and position from the slot rows
        for row, _ in pf_done:
            flags[row] |= 2
        parts = [tokens, slots, positions, flags, dec_rem, eos_row]
        if nt:
            parts += tiles
        dirty = self._sync_bt()
        staged = self._stage(np.concatenate(parts))
        w = self._table_width(max_pos)
        t = tokens.shape[0]
        packed = self.programs.run(("fused", t, k, nd, nt, w),
                                   self._get_dev_fused(t, k, nd, nt, w, staged))
        self._push_chunk(packed, k, nd, decs, chunks, pf_done)
        self._note_dispatch(t0, 1 + (k - 1) * (nd > 0))
        self._note_steady(not chunks, dirty, (staged.shape[0], tuple(slots)), h2d0, stage0)
        return True

    def _push_chunk(self, packed: torch.Tensor, k: int, nd: int, decs, chunks,
                    pf_done) -> None:
        """Enter a dispatched chunk into the window: its output copied to the
        host right behind it, each participant referenced (released only
        when every chunk referencing it is reconciled), and each decoding or
        prompt-completing slot marked as fed from the device."""
        participants: dict[int, _SeqState] = {}
        for seq, k_s in decs:
            seq.pos += k_s
            self._slot_feed[seq.slot] = True
            participants[seq.slot] = seq
        for _, seq in pf_done:
            self._slot_feed[seq.slot] = True
            participants[seq.slot] = seq
        for seq, _, _ in chunks:
            participants[seq.slot] = seq
        for seq in participants.values():
            seq.refs += 1
            self._hist_stale[seq.slot] = True
        self._inflight_chunks.append({
            "out": self._readback(packed), "k": k, "nd": nd, "decs": decs,
            "pf_done": pf_done, "participants": list(participants.values())})

    def _reconcile_oldest(self) -> dict:
        """Read back the OLDEST chunk in flight and fold its tokens into host
        state: a prompt-completing row's first token, then each decode row's
        ``k_s`` tokens, cut at EOS and at ``max_new_tokens`` (speculated
        tokens past either are discarded); then the deferred releases."""
        rec = self._inflight_chunks.pop(0)
        packed = self._read(rec["out"])
        n_dec = rec["k"] * rec["nd"]
        dec_toks = packed[:n_dec].reshape(rec["k"], rec["nd"])
        tok0 = packed[n_dec:]
        out: dict = {}
        for row, seq in rec["pf_done"]:
            self._append_tokens(seq, [int(tok0[row])], out)
        for j, (seq, k_s) in enumerate(rec["decs"]):
            self._append_tokens(seq, dec_toks[:k_s, j], out)
        self._drop_refs(rec["participants"])
        return out

    def _step_fused(self) -> dict:
        """One fused-pipeline turn: fill the window of ``pipeline_depth``
        chunks, then reconcile the oldest when the window is full or nothing
        new could be dispatched."""
        dispatched = False
        while len(self._inflight_chunks) < self.cfg.pipeline_depth:
            if not self._dispatch_fused():
                break
            dispatched = True
        if self._inflight_chunks and (
                not dispatched or len(self._inflight_chunks) >= self.cfg.pipeline_depth):
            return self._reconcile_oldest()
        if not dispatched and not self._inflight_chunks:
            self._deadlock_guard(0)
        return {}

    def _sched_eligible(self) -> bool:
        """Whether a scheduler turn could engage now: everything running
        decodes and admission pressure does not forbid a chunk (the checks
        ``_dispatch_sched_device`` makes before it plans)."""
        seqs = [s for s in self._running.values() if not s.finished]
        if not seqs or any(not s.in_decode for s in seqs):
            return False
        return not (self._queued and self._free_slots
                    and min(self.cfg.sched_steps, self.cfg.run_ahead_admission_cap) < 1)

    def _step_fused_sched(self) -> dict:
        """The fused pipeline with the scheduler on top: mixed prefill and
        decode waves run as fused chunks; once the batch is all-decode the
        turn goes to the scheduler (``_step_device``). The two windows never
        interleave: each drains before the other dispatches, so every
        sequence's dispatches reconcile in order."""
        self._admit_queued()
        if self._sched_eligible():
            if self._inflight_chunks:
                return self._reconcile_oldest()
            return self._step_device()
        if self._pending:
            return self._reconcile_pending()
        return self._step_fused()

    def drain(self) -> dict:
        """Reconcile every fused chunk in flight and every pending dispatch
        (a flush point for callers that need host-complete state)."""
        out: dict = {}
        while self._inflight_chunks:
            out.update(self._reconcile_oldest())
        while self._pending:
            out.update(self._reconcile_pending())
        return out

    # ------------------------------------------------------------ convenience
    def generate_all(self, max_steps: int = 10_000) -> dict:
        """Drive ``step()`` until all queued/admitted work finishes and every
        pending dispatch is reconciled; returns {uid: generated token list}."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        self.drain()
        if self.has_work:
            raise RuntimeError(f"work left after {max_steps} steps")
        return {uid: list(seq.generated) for uid, seq in self._results.items()}
