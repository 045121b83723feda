"""Bounded inter-stage queues with the reference's backpressure semantics
(a copy of scaloam_tpu/runtime/queues.py).

Reference: every ROS subscriber uses queue depth 100 (e.g.
src/laserOdometry.cpp:195-213); the mapping stage additionally DROPS its
backlog to stay real-time (src/laserMapping.cpp:300-304), and the PGO node
warns when its loop-candidate queue exceeds 30
(src/laserPosegraphOptimization.cpp:750-752).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional


class BoundedQueue:
    """Thread-safe FIFO with drop-oldest overflow and optional drain-latest.

    put(): appends; when full, the oldest item is dropped (counted).
    get(): blocks for the next item.
    get_latest(): drains everything and returns the newest item — the
    mapping node's real-time policy.
    """

    def __init__(self, maxlen: int = 100, name: str = ""):
        self._dq: collections.deque = collections.deque()
        self._maxlen = maxlen
        self._cv = threading.Condition()
        self._closed = False
        self.dropped = 0
        self.name = name

    def put(self, item: Any) -> None:
        with self._cv:
            if len(self._dq) >= self._maxlen:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(item)
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._cv:
            while not self._dq and not self._closed:
                if not self._cv.wait(timeout):
                    return None
            if self._dq:
                return self._dq.popleft()
            return None  # closed and empty

    def get_latest(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Drop backlog, return newest (laserMapping.cpp:300-304)."""
        with self._cv:
            while not self._dq and not self._closed:
                if not self._cv.wait(timeout):
                    return None
            if not self._dq:
                return None
            self.dropped += max(0, len(self._dq) - 1)
            item = self._dq[-1]
            self._dq.clear()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def clear(self) -> int:
        """Discard the backlog (abort path); returns the count dropped."""
        with self._cv:
            n = len(self._dq)
            self._dq.clear()
            self.dropped += n
            self._cv.notify_all()
            return n

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)
