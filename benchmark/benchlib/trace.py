"""The device trace of a traced window, read from torch.profiler's raw
(kineto) events: the device's busy intervals, each kernel's device time,
which step launched it, and what the host was doing in each idle gap."""

from __future__ import annotations

import bisect
import collections
import re
from typing import List, NamedTuple, Optional

from benchlib import stats

WINDOW = "bench.window"


class Kernel(NamedTuple):
    name: str
    start: float  # s
    end: float
    step: Optional[str]  # module of the captured step whose replay launched it


class Trace(NamedTuple):
    window: tuple  # (start s, end s) of the traced window
    busy: List[tuple]  # device activity intervals (kernels, copies, sets)
    kernels: List[Kernel]
    spans: List[tuple]  # (start s, end s, name) of the host's bench.span ranges

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        a, b = self.window
        return stats.busy_seconds([(max(s, a), min(e, b)) for s, e in self.busy if e > a and s < b])


def read(kineto_events) -> Trace:
    """The Trace of one profiled region holding one `bench.window` range."""
    from torch.autograd import DeviceType

    window, ranges, steps, launch_at, device = None, [], [], {}, []
    cuda = DeviceType.CUDA
    for e in kineto_events:
        name = e.name()
        start = e.start_ns() * 1e-9
        if e.device_type() == cuda:
            if not name.startswith("bench."):  # not a range mirrored on the device
                device.append((start, start + e.duration_ns() * 1e-9, name,
                               e.correlation_id(), e.linked_correlation_id()))
        elif name.startswith("bench."):
            end = start + e.duration_ns() * 1e-9
            if name == WINDOW:
                window = (start, end)
            elif name.startswith("bench.step:"):
                steps.append((start, end, name[len("bench.step:"):]))
            else:
                ranges.append((start, end, name[len("bench.span:"):]))
        elif name.startswith("cu"):
            launch_at[e.correlation_id()] = start
    if window is None:
        raise ValueError("the trace holds no bench.window range")
    steps.sort()
    step_starts = [s[0] for s in steps]
    kernels, busy = [], []
    for start, end, name, corr, linked in device:
        busy.append((start, end))
        if name.startswith("Memcpy") or name.startswith("Memset"):
            continue
        at = launch_at.get(corr, launch_at.get(linked))
        kernels.append(Kernel(name, start, end, _enclosing(steps, at, step_starts)))
    return Trace(window, busy, kernels, sorted(ranges))


def _enclosing(ranges: List[tuple], t: Optional[float], starts=None) -> Optional[str]:
    """The name of the latest starting of the sorted, unnested ranges that
    holds t (`starts`: their starts, where the caller keeps them)."""
    if t is None or not ranges:
        return None
    k = bisect.bisect_right([r[0] for r in ranges] if starts is None else starts, t) - 1
    return ranges[k][2] if k >= 0 and ranges[k][1] >= t else None


def kernel_matches(name: str, kernel: str) -> bool:
    """Whether a device kernel's (demangled) name is the function `kernel`."""
    return re.search(rf"(^|[\s:]){re.escape(kernel)}\s*[<(]", name) is not None or name == kernel


def device_ops(trace: Trace, top: int = 10) -> list:
    """[[kernel or copy name, device seconds]] of the most time, summed by
    name, within the window."""
    a, b = trace.window
    total = collections.Counter()
    for k in trace.kernels:
        if a <= k.start < b:
            total[_short(k.name)] += k.end - k.start
    return [[n, s] for n, s in total.most_common(top)]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest stretches of the
    window with nothing on the device: the innermost span on the host at
    the gap's middle, else the harness's own code."""
    a, b = trace.window
    gaps = stats.idle_gaps([(max(s, a), min(e, b)) for s, e in trace.busy if e > a and s < b], a, b)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return [[_enclosing(trace.spans, (g0 + g1) / 2) or "harness", g1 - g0]
            for g0, g1 in gaps[:top]]


def _short(name: str) -> str:
    """A kernel's name, at most its first 120 characters."""
    return name[:120] if name else "(no name)"
