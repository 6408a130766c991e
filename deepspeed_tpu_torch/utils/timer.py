"""Step throughput (counterpart of ``deepspeed_tpu/utils/timer.py:96 ThroughputTimer``).

PyTorch returns before the device finishes, so a host clock alone would
time the enqueue. ``start()`` and ``stop()`` therefore synchronise the
device first (``synchronize`` is ``torch.cuda.synchronize`` for the card and
a no-op for the CPU) and then read the host clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from deepspeed_tpu_torch.utils.logging import log_dist


def _no_sync() -> None:
    return None


@dataclass
class ThroughputTimer:
    """Samples/s and TFLOPS per step."""

    batch_size: int = 1
    steps_per_output: int = 100
    synchronize: Callable[[], None] = _no_sync
    total_elapsed: float = field(default=0.0, init=False)
    step_count: int = field(default=0, init=False)
    flops_per_sample: float = field(default=0.0, init=False)
    last_duration: float = field(default=0.0, init=False)  # most recent start->stop
    _start: float = field(default=0.0, init=False)
    _started: bool = field(default=False, init=False)

    def start(self) -> None:
        self.synchronize()
        self._start = time.perf_counter()
        self._started = True

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self._started:
            return
        self.synchronize()
        self._started = False
        duration = time.perf_counter() - self._start
        self.last_duration = duration
        self.total_elapsed += duration
        if global_step:
            self.step_count += 1
            if (report_speed and self.steps_per_output
                    and self.step_count % self.steps_per_output == 0):
                log_dist(
                    f"step={self.step_count} samples/sec={self.throughput():.2f} "
                    f"avg_step_ms={1000 * self.total_elapsed / self.step_count:.1f}",
                    ranks=[0])

    def throughput(self) -> float:
        if self.step_count <= 0 or self.total_elapsed <= 0:
            return 0.0
        return self.batch_size * self.step_count / self.total_elapsed

    def tflops(self) -> float:
        if self.flops_per_sample <= 0:
            return 0.0
        return self.flops_per_sample * self.throughput() / 1e12
