"""What the program records of itself in a traced window: the spans of
`scaloam_tpu_torch.utils.timing`, on while the window's profiler session
records. Each span gives its name, its parent, its host time, its start on
the profiler's clock, the stream time between its CUDA events where it has
them, and the counts its site attached (bytes moved at the compile
boundary, scans carried by an entry).

A program that keeps no spans gives nothing to read: `records()` is None,
and each metric reads None.

A record's start is placed on the profiler's clock by the host's real-time
clock, which can lie up to ~0.34 ms from kineto's own timestamps (H100
host, torch 2.11): the idle split cannot tell apart entries below ~0.5 ms
a scan.
"""

from __future__ import annotations

import collections
import sys
from typing import List, Optional

from benchlib import stats

# The spans of the calls into the front end, which carry the scans.
ENTRY_SPANS = ("frontend.step", "multiseq.frame_batch")
# The bytes a replay moves at the compile boundary: into the step's input
# buffers, inside the graph into them, back into the caller's state, and
# into fresh outputs.
BOUNDARY_BYTES = ("compiled.copy_in_bytes", "compiled.keep_bytes",
                  "compiled.write_back_bytes", "compiled.clone_bytes")
# The host work of a call into a captured step: bind, flatten and key; the
# copies into its input buffers; the fresh outputs and the write-back. The
# graph's launch (`compiled.launch`) is left out: under the profiler's
# device tracing its host time grows with the graph's nodes, ~35 times its
# untraced cost (tools/torch_boundary_probe.py reads it untraced).
BOUNDARY_HOST = ("compiled.key", "compiled.copy_in", "compiled.outputs")
# Spans whose host time the profiler inflates: their idle time is printed
# in the split but left out of idle_in_program_ms_per_scan.
INFLATED = ("compiled.launch",)


def records() -> Optional[list]:
    """The program's span records of the last profiler session, or None
    where the program keeps none."""
    try:
        from scaloam_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "records", None)
    return read() if read is not None else None


def entry_scans(recs: list) -> int:
    """The scans the entry spans carried."""
    return int(sum(r.counts.get("scans", 0) for r in recs if r.name in ENTRY_SPANS))


def entry_device_ms_per_scan(recs: Optional[list]) -> Optional[float]:
    """The stream time between the entry spans' CUDA events (ms), over the
    scans they carried."""
    if not recs:
        return None
    scans = entry_scans(recs)
    ms = [r.device_ms for r in recs if r.name in ENTRY_SPANS and r.device_ms is not None]
    return sum(ms) / scans if ms and scans else None


def boundary_mb_per_scan(recs: Optional[list]) -> Optional[float]:
    """The bytes the window's replays moved at the compile boundary
    (1 MB = 1e6 B), over the scans the entry spans carried."""
    if not recs:
        return None
    scans = entry_scans(recs)
    counted = [r for r in recs if any(c in r.counts for c in BOUNDARY_BYTES)]
    if not counted or not scans:
        return None
    return sum(r.counts.get(c, 0) for r in counted for c in BOUNDARY_BYTES) / 1e6 / scans


def boundary_host_ms_per_scan(recs: Optional[list]) -> Optional[float]:
    """The host time of the compile boundary (ms): each call's key, its
    copies in and its outputs (BOUNDARY_HOST, not the graph's launch),
    over the scans the entry spans carried."""
    if not recs:
        return None
    scans = entry_scans(recs)
    ns = [r.host_ns for r in recs if r.name in BOUNDARY_HOST]
    return sum(ns) / 1e6 / scans if ns and scans else None


def ranges(recs: list) -> List[tuple]:
    """(start s, end s, name) of every span on the profiler's clock."""
    return [(r.start_ns * 1e-9, (r.start_ns + r.host_ns) * 1e-9, r.name) for r in recs]


def idle_by_span(trace, spans: List[tuple]) -> dict:
    """{innermost open span, or None: seconds} of the window's stretches
    with nothing on the device (`stats.idle_gaps` over the trace's busy
    intervals), split by the span open on the host that started last."""
    a, b = trace.window
    gaps = stats.idle_gaps([(max(s, a), min(e, b)) for s, e in trace.busy if e > a and s < b],
                           a, b)
    # The window cut at every span's edges: between two edges the open
    # spans, and so the innermost, are fixed.
    pieces, open_, t = [], {}, a
    for at, kind, k in sorted([(s, 1, k) for k, (s, _, _) in enumerate(spans)]
                              + [(e, -1, k) for k, (_, e, _) in enumerate(spans)]):
        at = min(max(at, a), b)
        if at > t:
            pieces.append((t, at, _innermost(open_, spans)))
            t = at
        if kind > 0:
            open_[k] = spans[k][0]
        else:
            open_.pop(k, None)
    if t < b:
        pieces.append((t, b, _innermost(open_, spans)))
    out, i = collections.Counter(), 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            out[name] += min(p1, g1) - max(p0, g0)
            j += 1
    return dict(out)


def _innermost(open_: dict, spans: List[tuple]) -> Optional[str]:
    """The open span that started last (of two, the one that ends first)."""
    if not open_:
        return None
    return spans[max(open_, key=lambda k: (open_[k], -spans[k][1]))][2]


def idle_in_program_ms_per_scan(trace, recs: Optional[list], scans: int) -> Optional[float]:
    """The window's device-idle time during which some program span other
    than an INFLATED one is innermost on the host (ms), over the window's
    scans. Prints to standard error the split by innermost span, each with
    the counts its spans carried a scan (bytes uploaded, leaves keyed), and
    the idle time under none."""
    if not recs or trace is None or not scans:
        return None
    split = idle_by_span(trace, ranges(recs))
    under = {k: v for k, v in split.items() if k is not None}
    counts = collections.defaultdict(collections.Counter)
    for r in recs:
        counts[r.name].update(r.counts)
    parts = ", ".join(f"{k} {v * 1e3 / scans:.4f}"
                      + "".join(f" ({c} {n / scans:.6g})" for c, n in sorted(counts[k].items()))
                      for k, v in sorted(under.items(), key=lambda kv: -kv[1]))
    print(f"idle_in_program: ms a scan by innermost span (counts a scan): {parts}; "
          f"under no program span {split.get(None, 0.0) * 1e3 / scans:.4f}; left out of the "
          f"sum: {', '.join(INFLATED)}", file=sys.stderr)
    return sum(v for k, v in under.items() if k not in INFLATED) * 1e3 / scans
