"""Serving tier of the port (counterpart of ``deepspeed_tpu/serving``):
an HTTP frontend, a replica router and per-replica engine loops over the
ragged engine, stdlib only besides the engine itself.

- :mod:`protocol` — request/response dataclasses, validation, SSE framing
- :mod:`engine_loop` — per-replica background step-loop driver
  (``put()``/``step()`` pump, per-request token streams, graceful drain,
  crash containment and respawn)
- :mod:`router` — least-outstanding-tokens placement + KV-aware admission
  control + bounded queues (429 backpressure) + a per-replica circuit
  breaker and failover
- :mod:`frontend` — ``http.server`` HTTP surface: ``POST /v1/completions``
  (JSON + SSE), ``GET /healthz``, ``GET /metrics``, ``GET /debug/trace``
- :mod:`faults` — deterministic fault injection at the real seams (drives
  the engine's dispatch watchdog, crash containment and replica failover)
- :mod:`cluster` — disaggregated prefill/decode serving: role-tagged
  replicas, KV-handoff transfer, a cluster-wide prefix index, and an
  SLO-burn-driven decode-pool autoscaler

Start a server with ``build_server([engine])`` or
``build_cluster_server([prefill], [decode])``, after each engine's
``warmup()``.
"""

from deepspeed_tpu_torch.serving.cluster import (  # noqa: F401
    ClusterConfig,
    ClusterPrefixIndex,
    DecodeAutoscaler,
    InMemoryTransferChannel,
    ServingCluster,
    build_cluster_server,
    transfer_beats_prefill,
)
from deepspeed_tpu_torch.serving.engine_loop import (  # noqa: F401
    EngineLoop,
    ReplicaDraining,
    ReplicaStats,
    StreamError,
    TokenStream,
)
from deepspeed_tpu_torch.serving.frontend import (  # noqa: F401
    ServingFrontend,
    build_server,
)
from deepspeed_tpu_torch.serving.protocol import (  # noqa: F401
    FINISH_CANCELLED,
    FINISH_LENGTH,
    FINISH_STOP,
    FINISH_TIMEOUT,
    CompletionRequest,
    CompletionResponse,
    ProtocolError,
    decode_sse,
    encode_sse,
    sse_done,
)
from deepspeed_tpu_torch.serving.faults import (  # noqa: F401
    POINT_ALLOC,
    POINT_CKPT_COLLECT,
    POINT_CKPT_COMMIT,
    POINT_CKPT_FLUSH,
    POINT_CKPT_LATEST,
    POINT_CKPT_LOAD,
    POINT_DISPATCH,
    POINT_H2D,
    POINT_LOOP,
    POINT_READBACK,
    POINT_SUBMIT,
    FatalFaultError,
    FaultError,
    FaultInjector,
    FaultSpec,
    classify_transient,
    is_resource_exhausted,
    get_fault_injector,
)
from deepspeed_tpu_torch.serving.router import (  # noqa: F401
    DeadlineExceeded,
    Draining,
    Overloaded,
    ReplicaRouter,
    RouterConfig,
    plan_placement,
)
