"""The arithmetic of the metrics, shared by the readers in metrics/."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

# The spans around the calls into the front end (drivers/): FrontEnd.step,
# the batched frame_batch.
FRONT_SPANS = ("frontend_step", "frame_batch")


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, by the nearest rank: the
    smallest value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def rate(count: int, seconds: float) -> float:
    """Work completed over the window's whole time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def busy_seconds(intervals: Sequence[tuple]) -> float:
    """The length of the union of [start, end) intervals (seconds)."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Sequence[tuple], start: float, stop: float) -> list:
    """The [a, b) stretches of [start, stop) that no interval covers."""
    gaps, t = [], start
    for a, b in sorted(intervals):
        if a > t:
            gaps.append((t, min(a, stop)))
        t = max(t, b)
        if t >= stop:
            break
    if t < stop:
        gaps.append((t, stop))
    return [(a, b) for a, b in gaps if b > a]


def median_ms(latencies: Sequence[float]) -> Optional[float]:
    """The median of every scan's latency, in ms."""
    return statistics.median(latencies) * 1e3 if latencies else None


def front_ms_per_scan(spans: dict, scans: int) -> Optional[float]:
    """The stream time of the FRONT_SPANS calls (ms), over the scans they
    carried."""
    ms = sum(r["device_ms"] for name, r in spans.items() if name in FRONT_SPANS)
    return ms / scans if ms and scans else None


def idle_pct(trace) -> Optional[float]:
    """The share of a traced window with no kernel or copy on the card."""
    w = trace.window_s
    return 100.0 * (1.0 - trace.busy_s() / w) if w > 0 else None
