"""Per-collective communication logging (counterpart of
``deepspeed_tpu/utils/comms_logging.py``).

Every collective issued through ``deepspeed_tpu_torch.comm.comm`` records
op name, bytes, call count and its measured latency; ``log_summary``
renders the table with algorithmic and bus bandwidth (``calc_bw_log``,
the reference's formulas) and, across processes, min/max latency for
straggler detection.

The JAX package keeps two ledgers: a trace-time one for collectives inside
its compiled step (bytes only) and an eager one with wall-clock latency.
The port's step is eager, so it keeps the eager one alone: every record
has a measured latency.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from deepspeed_tpu_torch.utils.logging import log_dist, logger


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n_ranks: int):
    """Algorithmic and bus bandwidth in GB/s (reference: comms_logging.py:34)."""
    duration_s = max(duration_s, 1e-12)
    if comm_op in ("all_to_all",):
        tput = size_bytes / duration_s
        busbw = tput * ((n_ranks - 1) / max(n_ranks, 1))
    elif comm_op in ("all_gather", "reduce_scatter"):
        size_bytes *= n_ranks
        tput = size_bytes / duration_s
        busbw = (size_bytes / duration_s) * ((n_ranks - 1) / max(n_ranks, 1))
    elif comm_op in ("all_reduce", "psum"):
        tput = size_bytes * 2 / duration_s
        busbw = (size_bytes / duration_s) * (2 * (n_ranks - 1) / max(n_ranks, 1))
    else:  # send/recv/broadcast/ppermute
        tput = size_bytes / duration_s
        busbw = tput
    return tput / 1e9, busbw / 1e9


@dataclass
class _OpRecord:
    count: int = 0
    total_bytes: int = 0
    total_latency: float = 0.0  # seconds
    n_ranks: int = 1  # participants of the last call (bandwidth accounting)


class CommsLogger:
    def __init__(self, enabled: bool = False, verbose: bool = False, debug: bool = False,
                 prof_all: bool = True, prof_ops: list | None = None,
                 straggler_warn_ratio: float = 2.0):
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.straggler_warn_ratio = straggler_warn_ratio
        self.eager: dict[str, _OpRecord] = defaultdict(_OpRecord)

    def configure(self, cfg) -> None:
        self.enabled = cfg.enabled
        self.verbose = cfg.verbose
        self.debug = cfg.debug
        self.prof_all = cfg.prof_all
        self.prof_ops = list(cfg.prof_ops)
        self.straggler_warn_ratio = float(
            getattr(cfg, "straggler_warn_ratio", self.straggler_warn_ratio))

    def _should_log(self, op_name: str) -> bool:
        return self.enabled and (self.prof_all or op_name in self.prof_ops)

    def append_eager(self, op_name: str, size_bytes: int, latency_s: float, n_ranks: int) -> None:
        from deepspeed_tpu_torch.telemetry import TELEMETRY

        if TELEMETRY.enabled:
            TELEMETRY.counter("comm_eager_calls_total",
                              "host-level collectives issued").inc(1, op=op_name)
            TELEMETRY.counter("comm_eager_bytes_total",
                              "bytes moved by host-level collectives").inc(size_bytes, op=op_name)
            TELEMETRY.histogram("comm_eager_latency_seconds",
                                "host-level collective wall clock").observe(latency_s, op=op_name)
        if not self._should_log(op_name):
            return
        rec = self.eager[op_name]
        rec.count += 1
        rec.total_bytes += size_bytes
        rec.total_latency += latency_s
        rec.n_ranks = max(n_ranks, 1)
        if self.verbose:
            algbw, busbw = calc_bw_log(op_name, size_bytes, latency_s, n_ranks)
            log_dist(f"comm: {op_name} | bytes={size_bytes} latency={latency_s * 1e3:.3f}ms "
                     f"algbw={algbw:.2f}GB/s busbw={busbw:.2f}GB/s", ranks=[0])

    def rows(self) -> dict:
        """Op -> {calls, bytes, avg_ms, algbw_gbps, busbw_gbps} of the eager
        ledger (the summary's numbers, for programs that print JSON)."""
        out = {}
        for op, rec in sorted(self.eager.items()):
            n = max(rec.count, 1)
            algbw, busbw = calc_bw_log(op, rec.total_bytes / n, rec.total_latency / n,
                                       rec.n_ranks)
            out[op] = {"calls": rec.count, "bytes": rec.total_bytes,
                       "avg_ms": 1e3 * rec.total_latency / n, "n_ranks": rec.n_ranks,
                       "algbw_gbps": algbw, "busbw_gbps": busbw}
        return out

    def log_summary(self, show_straggler: bool = False) -> str:
        lines = ["Comms summary (eager collectives):"]
        for op, row in self.rows().items():
            lines.append(
                f"  {op:>18}: calls={row['calls']:<6} total={row['bytes'] / 1e6:.2f} MB "
                f"avg={row['avg_ms']:.3f}ms algbw={row['algbw_gbps']:.2f}GB/s "
                f"busbw={row['busbw_gbps']:.2f}GB/s")
        if show_straggler:
            lines += self._straggler_lines()
        text = "\n".join(lines)
        logger.info(text)
        return text

    def _straggler_lines(self) -> list[str]:
        """Min/max eager latency across processes (reference: log_summary(show_straggler))."""
        try:
            import numpy as np

            from deepspeed_tpu_torch.comm import comm

            if comm.get_world_size() <= 1:
                return ["  (single process; no straggler data)"]
            lines = ["Straggler analysis (min/max across processes, "
                     f"warn ratio {self.straggler_warn_ratio:.2f}):"]
            for op, rec in sorted(self.eager.items()):
                mine = np.asarray([rec.total_latency], dtype=np.float32)
                gathered = comm.host_allgather(mine)
                mn, mx = float(gathered.min()), float(gathered.max())
                ratio = mx / max(mn, 1e-12)
                line = f"  {op:>18}: min={mn * 1e3:.3f}ms max={mx * 1e3:.3f}ms ratio={ratio:.2f}"
                if ratio > self.straggler_warn_ratio:
                    line += "  <-- STRAGGLER"
                    logger.warning(
                        f"comm straggler: {op} max/min latency ratio {ratio:.2f} exceeds "
                        f"{self.straggler_warn_ratio:.2f} (min={mn * 1e3:.3f}ms "
                        f"max={mx * 1e3:.3f}ms)")
                lines.append(line)
            return lines
        except Exception as e:  # pragma: no cover
            return [f"  (straggler gather failed: {e})"]

    def reset(self) -> None:
        self.eager.clear()


COMMS_LOGGER = CommsLogger()
