"""Wire protocol for the serving frontend: request/response dataclasses,
validation, and SSE framing (counterpart of
``deepspeed_tpu/serving/protocol.py``; the same fields and error texts).

The HTTP surface is OpenAI-completions-shaped (``POST /v1/completions``,
non-streaming JSON or ``text/event-stream``), with one deliberate difference:
the stack has no tokenizer, so ``prompt`` is a list of token ids and
responses carry token ids — the serving tier is the engine-facing half of a
deployment (DeepSpeed-MII's role over the reference v2 engine), and
detokenization belongs to whatever owns the vocabulary.

Everything here is pure data + validation — no sockets, no threads — so the
router/frontend tests can exercise the math without binding a port.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field

# terminal states a completion can end in (finish_reason on the wire)
FINISH_STOP = "stop"          # hit eos_token_id
FINISH_LENGTH = "length"      # hit max_tokens
FINISH_CANCELLED = "cancelled"  # client disconnect / explicit cancel
FINISH_TIMEOUT = "timeout"    # per-request deadline expired


class ProtocolError(ValueError):
    """Invalid request payload (maps to HTTP 400)."""


# documented admission-priority range (lower = sooner); anything outside is
# a validation error, not a silent clamp — an out-of-range priority is
# almost always a units bug on the client side
PRIORITY_MIN = -32
PRIORITY_MAX = 32

# SLA classes a request may declare: "interactive" gets
# the tight ttft/decode objectives, "batch" the relaxed ones
SLA_CLASSES = ("interactive", "batch")

# bound on the tenant identifier so the label can't smuggle unbounded
# cardinality or junk into the metrics pipeline
TENANT_MAX_LEN = 64


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProtocolError(msg)


@dataclass
class CompletionRequest:
    """One validated completion request.

    ``priority`` orders admission within a replica's inbox (lower = sooner);
    ``deadline_s`` bounds the request's whole lifetime including queue wait
    (expiry releases its KV blocks and returns finish_reason=timeout).
    """

    prompt: list[int]
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stream: bool = False
    eos_token_id: int | None = None
    deadline_s: float | None = None
    priority: int = 0
    # pins the request's sampling stream: the same (prompt, seed, sampling
    # params) replays the same tokens on any replica, cold or prefix-cached
    seed: int | None = None
    # billing identity and latency class: tenant names the party billed for
    # this request's capacity (carried for the cost meter, ROADMAP.md queue
    # 1 item 14); sla_class selects the SLO objectives it is measured against
    tenant: str = "default"
    sla_class: str = "interactive"
    request_id: str = field(
        default_factory=lambda: "cmpl-" + uuid.uuid4().hex[:24])
    # not wire fields: the frontend attaches the sampled TraceContext here
    # (None = untraced) and stamps submit time so the engine loop can record
    # the inbox-wait span retroactively
    trace_ctx: object = field(default=None, repr=False, compare=False)
    t_submit: float = field(default=0.0, repr=False, compare=False)
    # not wire fields (disaggregated serving, serving/cluster.py): the
    # cluster marks the prefill-stage copy of a request with ``handoff`` so
    # the engine parks its KV for export instead of decoding, and the router
    # stamps the placement-time prefix-probe credit in ``cached_tokens_hint``
    # so admission can re-validate the splice (stale-probe fix)
    handoff: bool = field(default=False, repr=False, compare=False)
    cached_tokens_hint: int = field(default=0, repr=False, compare=False)

    def __post_init__(self):
        _require(isinstance(self.prompt, (list, tuple)) and len(self.prompt) > 0,
                 "prompt must be a non-empty list of token ids")
        try:
            self.prompt = [int(t) for t in self.prompt]
        except (TypeError, ValueError):
            raise ProtocolError("prompt must contain integers") from None
        _require(all(t >= 0 for t in self.prompt),
                 "prompt token ids must be non-negative")
        _require(int(self.max_tokens) >= 1, "max_tokens must be >= 1")
        self.max_tokens = int(self.max_tokens)
        _require(float(self.temperature) >= 0.0, "temperature must be >= 0")
        self.temperature = float(self.temperature)
        _require(int(self.top_k) >= 0, "top_k must be >= 0")
        self.top_k = int(self.top_k)
        _require(0.0 < float(self.top_p) <= 1.0, "top_p must be in (0, 1]")
        self.top_p = float(self.top_p)
        if self.deadline_s is not None:
            _require(float(self.deadline_s) > 0.0, "deadline_s must be > 0")
            self.deadline_s = float(self.deadline_s)
        if self.eos_token_id is not None:
            self.eos_token_id = int(self.eos_token_id)
        if self.seed is not None:
            _require(int(self.seed) >= 0, "seed must be >= 0")
            self.seed = int(self.seed)
        try:
            prio = int(self.priority)
        except (TypeError, ValueError):
            raise ProtocolError("priority must be an integer") from None
        _require(prio == self.priority,  # reject 1.5 — no silent truncation
                 "priority must be an integer")
        self.priority = prio
        _require(PRIORITY_MIN <= self.priority <= PRIORITY_MAX,
                 f"priority must be in [{PRIORITY_MIN}, {PRIORITY_MAX}], "
                 f"got {self.priority}")
        self.stream = bool(self.stream)
        _require(isinstance(self.request_id, str) and len(self.request_id) > 0,
                 "request_id must be a non-empty string")
        _require(isinstance(self.tenant, str)
                 and 0 < len(self.tenant) <= TENANT_MAX_LEN,
                 f"tenant must be a non-empty string of at most "
                 f"{TENANT_MAX_LEN} chars")
        _require(self.sla_class in SLA_CLASSES,
                 f"sla_class must be one of {list(SLA_CLASSES)}, "
                 f"got {self.sla_class!r}")

    @property
    def total_tokens(self) -> int:
        """Worst-case sequence length — the admission-control token budget."""
        return len(self.prompt) + self.max_tokens

    @classmethod
    def from_json(cls, body) -> "CompletionRequest":
        """Build + validate from a decoded JSON body (raises ProtocolError)."""
        _require(isinstance(body, dict), "request body must be a JSON object")
        known = {
            "prompt", "max_tokens", "temperature", "top_k", "top_p",
            "stream", "eos_token_id", "deadline_s", "priority", "request_id",
            "seed", "tenant", "sla_class",
        }
        unknown = set(body) - known
        _require(not unknown, f"unknown fields: {sorted(unknown)}")
        _require("prompt" in body, "missing required field: prompt")
        kwargs = {k: v for k, v in body.items() if v is not None}
        try:
            return cls(**kwargs)
        except ProtocolError:
            raise
        except (TypeError, ValueError) as e:
            raise ProtocolError(str(e)) from None


@dataclass
class CompletionResponse:
    """Terminal result of one request (the non-streaming response body; the
    streaming path sends the same shape as its final SSE frame)."""

    request_id: str
    tokens: list[int]
    finish_reason: str
    prompt_tokens: int
    created: float = field(default_factory=time.time)
    # trace id echoed to the client when the request was sampled
    trace_id: str | None = None
    # cost-attribution identity echoed back so clients can reconcile their
    # own accounting against the server-side ledger
    tenant: str | None = None
    sla_class: str | None = None

    def to_json(self) -> dict:
        out = {
            "id": self.request_id,
            "object": "completion",
            "created": self.created,
            "choices": [{
                "index": 0,
                "tokens": list(self.tokens),
                "finish_reason": self.finish_reason,
            }],
            "usage": {
                "prompt_tokens": self.prompt_tokens,
                "completion_tokens": len(self.tokens),
                "total_tokens": self.prompt_tokens + len(self.tokens),
            },
        }
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.tenant is not None:
            out["tenant"] = self.tenant
            out["sla_class"] = self.sla_class
        return out


# ----------------------------------------------------------------- SSE
SSE_DONE_DATA = "[DONE]"


def encode_sse(data, event: str | None = None) -> bytes:
    """One server-sent-event frame. ``data`` is a JSON-serializable object
    (or the literal ``[DONE]`` terminator string); JSON encoding guarantees
    no raw newlines, so one ``data:`` line per frame is always valid SSE."""
    payload = data if isinstance(data, str) else json.dumps(data)
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {payload}\n\n").encode("utf-8")


def sse_done() -> bytes:
    return encode_sse(SSE_DONE_DATA)


def decode_sse(payload: bytes) -> list:
    """Parse a byte stream of SSE frames back into the decoded ``data``
    values (dicts, or the ``[DONE]`` string). Multi-``data:``-line frames
    join with newlines per the SSE spec; comment/event lines are ignored."""
    out = []
    for block in payload.decode("utf-8").split("\n\n"):
        data_lines = [line[5:].lstrip() for line in block.splitlines()
                      if line.startswith("data:")]
        if not data_lines:
            continue
        data = "\n".join(data_lines)
        if data == SSE_DONE_DATA:
            out.append(data)
        else:
            try:
                out.append(json.loads(data))
            except json.JSONDecodeError:
                out.append(data)  # non-JSON data passes through verbatim
    return out
