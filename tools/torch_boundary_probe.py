"""Host time of the port's boundaries with the profiler off, and what a
span site costs.

    python tools/torch_boundary_probe.py [--cells a,b] [--steps N] [--seed S] [--span-cost]
                                         [--no-stream-events]

For each benchmark cell (benchmark/workloads/<cell>.json) the cell's
driver sets up and warms as the benchmark's harness does (one host thread,
no garbage collection in the window); then `--steps` steps run with the
port's spans recording but no profiler session (the spans' switch,
`timing._profiler_enabled`, is held on), so no device tracing inflates
the graph's launch. One JSON line a cell: the host ms a scan of each span
name, `boundary_host_ms_per_scan` as the benchmark's reader sums it (key,
copies in, outputs), the graph's launch beside it, and the steps' median
latency. `--no-stream-events` keeps the entry spans from recording CUDA
events (their stream time then reads None). `--span-cost` then prints the
host ns of a span site off, on, and on with CUDA events, and of the two
event records and two event creations such a span makes, under a profiler
session of the harness's activities; it runs after the cells, since a
graph's launch costs the host more for the rest of a process that has
run a profiler session. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]

import torch  # noqa: E402

from benchlib import driving, program, registry  # noqa: E402

ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _ns_a_site(n: int, site) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        site()
    return (time.perf_counter_ns() - t) / n


def span_cost(timing, n: int = 100_000) -> dict:
    def plain():
        with timing.span("probe") as s:
            s.add("probe.count", 1)

    def timed():
        with timing.span("probe", device=True):
            pass

    made = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def records():
        made[0].record()
        made[1].record()

    bare = _ns_a_site(n, lambda: None)
    out = {"off": _ns_a_site(n, plain) - bare, "bare_call": bare}
    with timing.span("off"):  # ends the last session
        pass
    with torch.profiler.profile(activities=ACTIVITIES):
        out["on"] = _ns_a_site(n, plain) - bare
        out["on_device_events"] = _ns_a_site(n // 10, timed) - bare
        out["two_event_records"] = _ns_a_site(n // 10, records) - bare
        out["two_event_creations"] = _ns_a_site(
            n // 10, lambda: (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))) - bare
        torch.cuda.synchronize()
    return {"span_ns": out}


def cell(name: str, seed: int, steps: int, device, stream_events: bool = True) -> dict:
    from scaloam_tpu_torch.utils import timing

    c = registry.workload(name)
    drv = registry.driver(c["driver"]).Driver(
        driving.Context(c, registry.config(c["config"]), seed, device))
    drv.setup()
    torch.cuda.synchronize()
    with timing.span("off"):  # ends the last session
        pass
    enabled, span = timing._profiler_enabled, timing.span
    timing._profiler_enabled = lambda: True
    if not stream_events:
        timing.span = lambda name, scans=0, device=False: span(name, scans)
    gc.collect()
    gc.freeze()
    gc.disable()
    latencies = []
    try:
        for _ in range(steps):
            latencies += drv.step()
        torch.cuda.synchronize()
    finally:
        timing._profiler_enabled, timing.span = enabled, span
        gc.enable()
        gc.unfreeze()
    recs = timing.records()
    scans = len(latencies)
    host = collections.Counter()
    for r in recs:
        host[r.name] += r.host_ns / 1e6 / scans
    drv.release()
    return {"cell": name, "scans": scans, "stream_events": stream_events,
            "boundary_host_ms_per_scan": program.boundary_host_ms_per_scan(recs),
            "launch_host_ms_per_scan": host["compiled.launch"],
            "host_ms_per_scan_by_span": dict(sorted(host.items())),
            "p50_ms": statistics.median(latencies) * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="mulran_os1_64.frontend,kitti_hdl64.fleet8")
    ap.add_argument("--steps", type=int, default=128, help="steps a cell (a batched frame in fleet8)")
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--no-stream-events", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from scaloam_tpu_torch.ops.kernels import _build
    from scaloam_tpu_torch.utils import timing

    _build.build()
    for source in _build.SOURCES:
        _build.library(source)
    for name in filter(None, args.cells.split(",")):
        print(json.dumps(cell(name, args.seed, args.steps, device,
                              stream_events=not args.no_stream_events)), flush=True)
    if args.span_cost:
        print(json.dumps(span_cost(timing)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
