"""The captured pose-graph optimise alone, timed three ways, so that two
checkouts can be compared on one card in one call: chip_smoke.py's phase
(a) tiers (1024 / 16, 4096 / 64 and 8192 / 256 nodes / loops on its
circle chains) and the system drive's 256-node tier (256 / 64, a chain
lapping a 64-node circle).

For each tier the key's first call (eager, then captured) is made first,
then `--ticks` replays, each timed as
- wall: from a synced card to the call's return and a sync, as phase (a)
  times its ticks;
- host: from the call to its return, before the sync (the host's share:
  the wrapper's copies, the graph's launch);
- device: CUDA events recorded before and after the call on the current
  stream;
and the ticks' span on the host's clock (Unix seconds), to set beside a
log of the card's clocks. Where wall exceeds device by more than a
launch, the host holds the card back. Each tier also reports its
kernels' launches a replay (chip_smoke's backend counters over the ticks:
the matvec, the chain solve, the segment sums) and, after every tier's
ticks, the device operations and host launches of one more replay under
torch.profiler (a profiled process's later replays are slower on the
host, so no tier is timed after one).

With --profile, that replay also gives their summed device time, the
kernels that take the most device time (name, count, us), and the idle
time between them (the gaps, summed by the operation that follows each),
so that two processes whose replays differ can be put side by side.
--nodes N[,N...] runs those tiers in that order (by default all four,
smallest first).

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_optimise_probe.py [--root DIR] [--ticks N] [--profile]
        [--nodes N[,N...]]

--root DIR imports scaloam_tpu_torch and chip_smoke.py from another
checkout (DIR). Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
TIERS = ((256, 64, 64), (1024, 16, 512), (4096, 64, 512), (8192, 256, 512))  # nodes, loops, lap


def main(argv) -> int:
    root, ticks, profiled, tiers = HERE, 10, False, TIERS
    while argv:
        if argv[0] == "--root" and len(argv) > 1:
            root, argv = argv[1], argv[2:]
        elif argv[0] == "--ticks" and len(argv) > 1:
            ticks, argv = int(argv[1]), argv[2:]
        elif argv[0] == "--profile":
            profiled, argv = True, argv[1:]
        elif argv[0] == "--nodes" and len(argv) > 1:
            tiers = [t for n in argv[1].split(",") for t in TIERS if t[0] == int(n)]
            argv = argv[2:]
        else:
            print("usage: torch_optimise_probe.py [--root DIR] [--ticks N] [--profile] "
                  "[--nodes N[,N...]]", file=sys.stderr)
            return 2
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_optimise_probe: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.types import Pose

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    counters = chip_smoke._backend_counters()
    rows, graphs = [], []
    for n, nl, lap in tiers:
        _, oq, ot, loops = chip_smoke.circle_chain(n, nl, seed=n, lap=lap)
        cfg = chip_smoke.chain_pgo_cfg(config.PGOConfig(), n, nl)
        g = chip_smoke.build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg.optimize(g, cfg)  # the key's first call: eager, then captured
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        wall, host, device = [], [], []
        for c in counters.values():
            c.launches = 0
        span = [time.time()]  # the ticks' start and end on the host's clock
        for _ in range(ticks):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            g = pg.optimize(g, cfg)
            end.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wall.append((t2 - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
            device.append(start.elapsed_time(end))
        span.append(time.time())
        med = lambda xs: float(np.median(xs))
        launches = {name: c.launches / ticks for name, c in counters.items()}
        rows.append(dict(nodes=n, loops=nl, first_call_ms=first_ms, wall_ms=wall, host_ms=host,
                         device_ms=device, wall_median=med(wall), host_median=med(host),
                         device_median=med(device), ticks_unix_s=span,
                         kernel_launches_per_replay=launches))
        graphs.append((g, cfg))
        print(f"{n} nodes / {nl} loops: wall {med(wall):.2f} ms, host {med(host):.2f}, "
              f"device {med(device):.2f} (medians of {ticks}); launches a replay {launches}",
              file=sys.stderr, flush=True)
    for row, (g, cfg) in zip(rows, graphs):
        call = lambda: pg.optimize(g, cfg)
        _, row["device_operations"], row["host_launches"] = chip_smoke.launch_profile(torch, call)
        if profiled:
            row["profile"] = device_profile(torch, call)
        print(f"{row['nodes']} nodes: {row['device_operations']} device operations, "
              f"{row['host_launches']} host launches a replay", file=sys.stderr, flush=True)
    print(json.dumps(dict(root=root, ticks=ticks, tiers=rows)), flush=True)
    return 0


def device_profile(torch, fn, top=12) -> dict:
    """One call of fn under torch.profiler: device operations, their summed
    device time (us) and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in p.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    by_name, gaps, end = {}, {}, None
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if end is not None and e.time_range.start > end:
            n, us = gaps.get(e.name, (0, 0.0))
            gaps[e.name] = (n + 1, us + e.time_range.start - end)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1][1])[:top]
    span = events[-1].time_range.end - events[0].time_range.start if events else 0.0
    return dict(device_operations=len(events), span_us=span,
                device_us=sum(us for _, us in by_name.values()),
                idle_us=sum(us for _, us in gaps.values()),
                top=[dict(name=k[:100], count=n, us=us) for k, (n, us) in rank(by_name)],
                idle_before=[dict(name=k[:100], count=n, us=us) for k, (n, us) in rank(gaps)])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
