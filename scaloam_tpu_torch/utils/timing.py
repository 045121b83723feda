"""Spans at the port's boundaries, and the per-stage timer with its
real-time budget alarm (reference: include/aloam_velodyne/tic_toc.h, the
100 ms warnings of src/scanRegistration.cpp:471-472 and
src/laserOdometry.cpp:594-595).

Spans: `with span(name, scans=0, device=False) as s: ...; s.add(counter, n)`.
Tracing is on exactly while a `torch.profiler` session records; off, a
span site costs one flag check and records nothing. On, a span records its
name, its parent (the enclosing span on this thread), the request (an id
shared by the spans opened inside one outermost span), its host time
(`time.perf_counter_ns`) and its start on the profiler's clock (the Unix
epoch in ns, as the profiler's own events), with `device=True` a pair of
CUDA events on the current stream (none while the stream captures), read
only by `records()`, and the counts its site adds, which also go to
`utils.metrics.GLOBAL`. It opens a profiler range `slam.<name>` of the
profiler's operator kind, so it lies on the timeline beside the device's
kernels and copies without being mirrored onto the device as an
annotation. The first span of a profiler session
clears the last session's records; `records()` reads them (after the
device has run the work). A span never sits inside a captured program's
body: a CUDA graph replays no host code.

`profile_trace()` is how an operator turns spans on around a run.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from scaloam_tpu_torch.utils.metrics import GLOBAL

log = logging.getLogger("scaloam")

MAX_RECORDS = 1 << 18  # a session's records kept; later spans are counted in `spans.dropped`

_profiler_enabled = torch.autograd._profiler_enabled
_local = threading.local()  # .stack: this thread's open spans
_requests = itertools.count(1)


class _Session:
    def __init__(self):
        self.live = False  # a span has seen this profiler session
        self.lock = threading.Lock()
        self.spans: List["_Span"] = []


_session = _Session()


class SpanRecord(NamedTuple):
    id: int
    name: str
    parent: Optional[int]  # the enclosing span's id
    request: int
    start_ns: int  # on the profiler's clock (Unix epoch ns)
    host_ns: int  # perf_counter_ns from open to close
    device_ms: Optional[float]  # stream time between its CUDA events
    counts: Dict[str, float]


class _Off:
    """The span of a site while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, counter: str, n: float) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("id", "name", "parent", "request", "start_ns", "t0", "host_ns",
                 "events", "device_ms", "counts", "_range")

    def __init__(self, name: str, scans: int, device: bool):
        self.name, self.counts, self.events, self.device_ms = name, {}, None, None
        if scans:
            self.add("scans", scans)
        if device and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def add(self, counter: str, n: float) -> None:
        """Attach a count to this span and add it to GLOBAL."""
        self.counts[counter] = self.counts.get(counter, 0) + n
        GLOBAL.inc(counter, n)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_requests)
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast("slam." + self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        self.t0 = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        self.host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _local.stack.pop()
        spans = _session.spans
        if len(spans) < MAX_RECORDS:
            spans.append(self)
        else:
            GLOBAL.inc("spans.dropped")
        return False


def span(name: str, scans: int = 0, device: bool = False):
    """A span around a boundary of the port (see the module docstring):
    `scans` it carries, `device` True to time its stream with CUDA events
    (the work runs on the current CUDA device)."""
    if not _profiler_enabled():
        _session.live = False
        return _OFF
    if not _session.live:
        with _session.lock:
            if not _session.live:
                _session.spans = []
                _session.live = True
    return _Span(name, scans, device)


def records() -> List[SpanRecord]:
    """The closed spans of the last profiler session, in the order they
    closed; waits for the device to run each span's end event."""
    with _session.lock:
        for s in _session.spans:
            if s.events is not None:
                start, end = s.events
                end.synchronize()
                s.device_ms, s.events = start.elapsed_time(end), None
    return [SpanRecord(s.id, s.name, s.parent, s.request, s.start_ns, s.host_ns, s.device_ms,
                       dict(s.counts)) for s in list(_session.spans)]


class StageTimer:
    """Named per-stage timing with rolling stats and a budget alarm. A
    stage ends once each CUDA device of `devices` (those its work runs on)
    has run its work, so it times the stage, not its enqueue."""

    def __init__(self, budget_ms: float = 100.0, window: int = 100, devices=()):
        self.budget_ms = budget_ms
        self.samples: Dict[str, collections.deque] = {}
        self.overruns: Dict[str, int] = collections.defaultdict(int)
        self._window = window
        self._cards = [d for d in dict.fromkeys(map(torch.device, devices)) if d.type == "cuda"]

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        for d in self._cards:
            torch.cuda.synchronize(d)
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


def profile_trace(log_dir: str = "build/trace"):
    """torch.profiler context over CPU and, when present, CUDA activity,
    with the port's spans on while it records (read them with `records()`);
    the trace lands in `log_dir` in the TensorBoard/Chrome trace format."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
