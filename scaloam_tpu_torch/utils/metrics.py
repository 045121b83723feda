"""Structured counters/observability (a copy of scaloam_tpu/utils/metrics.py).

Reference observability: cout progress lines ("posegraph keyframe node
added", src/laserPosegraphOptimization.cpp:688-689), loop found/not prints
(Scancontext.cpp:406-419), ROS_WARN alerts, rviz topics. Here: one counter
registry the pipeline updates — keyframes, loops proposed/verified/accepted,
GN residuals, queue drops, stage latencies — dumpable as a dict/JSON line.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Dict


class Metrics:
    def __init__(self):
        self._c: Dict[str, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, name: str, v: float = 1.0) -> None:
        with self._lock:
            self._c[name] += v

    def set(self, name: str, v: float) -> None:
        with self._lock:
            self._c[name] = v

    def get(self, name: str) -> float:
        with self._lock:
            return self._c.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._c)

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


GLOBAL = Metrics()
