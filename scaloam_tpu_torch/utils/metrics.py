"""The port's counters: one registry, `GLOBAL`, dumpable as a dict or a
JSON line (`run.py` prints it to stderr at exit).

Reference observability: cout progress lines ("posegraph keyframe node
added", src/laserPosegraphOptimization.cpp:688-689), loop found/not prints
(Scancontext.cpp:406-419). Always counted, once a keyframe:
`keyframes`, `loops.proposed` (ScanContext returned a candidate) and
`loops.accepted` (ICP passed, the loop factor added). Counted only while
tracing is on (`utils.timing`), as the counts of the spans that carry
them: `scans`, `scan.upload_bytes`, `compiled.host_reads` (the front end's
device-to-host reads), `compiled.leaves`, and the bytes a replay of a
captured step moves at its boundary,
`compiled.copy_in_bytes`, `compiled.keep_bytes`,
`compiled.write_back_bytes`, `compiled.clone_bytes`; `spans.dropped`
counts the spans past a session's record limit.
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
