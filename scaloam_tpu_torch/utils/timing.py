"""Per-stage timing + real-time budget alarms (TicToc parity, C11).

Reference: include/aloam_velodyne/tic_toc.h — TicToc/TicTocV2 millisecond
stopwatches, with warnings when a stage blows the 100 ms real-time budget
(src/scanRegistration.cpp:471-472, src/laserOdometry.cpp:594-595).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time
from typing import Dict, Optional

log = logging.getLogger("scaloam")


class TicToc:
    """Millisecond stopwatch (tic_toc.h:10-32)."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


class StageTimer:
    """Named per-stage timing with rolling stats and a budget alarm."""

    def __init__(self, budget_ms: float = 100.0, window: int = 100):
        self.budget_ms = budget_ms
        self.samples: Dict[str, collections.deque] = {}
        self.overruns: Dict[str, int] = collections.defaultdict(int)
        self._window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        ms = (time.perf_counter() - t0) * 1000.0
        self.record(name, ms)

    def record(self, name: str, ms: float) -> None:
        dq = self.samples.setdefault(name, collections.deque(maxlen=self._window))
        dq.append(ms)
        if ms > self.budget_ms:
            self.overruns[name] += 1
            log.warning("stage %s took %.1f ms (> %.0f ms budget)",
                        name, ms, self.budget_ms)

    def mean_ms(self, name: str) -> Optional[float]:
        dq = self.samples.get(name)
        return sum(dq) / len(dq) if dq else None

    def report(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.samples.items() if v}


def profile_trace(log_dir: str = "build/trace"):
    """torch.profiler context over CPU and, when present, CUDA activity; the
    trace lands in `log_dir` in the TensorBoard/Chrome trace format."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
