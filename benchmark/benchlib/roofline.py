"""A layer's hand kernels' share of their roofline over a traced window:
the least time their launches could take on the card (costs/, peaks.py)
over the device time they took (the trace), both summed over the launches
that the layer's captured steps replayed in the window."""

from __future__ import annotations

import collections
import sys

from benchlib import peaks, trace as trace_mod

# The front end's hand kernels (costs/) and the modules whose captured
# steps launch them.
FRONT_KERNELS = ("select_features", "associate_and_solve", "gn_solve_prepared", "sq_dist",
                 "sum3_sq", "ring_azimuth")
FRONT_MODULES = ("scaloam_tpu_torch.ops.features", "scaloam_tpu_torch.models.odometry",
                 "scaloam_tpu_torch.models.mapping", "scaloam_tpu_torch.models.pipeline",
                 "scaloam_tpu_torch.models.frontend", "scaloam_tpu_torch.parallel.multiseq")


def share(run, kernels, modules):
    """Percent, or None where the window replayed none of these kernels or
    the trace's launches do not match the launch records."""
    totals = run.launches.totals(modules)
    by_name = collections.defaultdict(lambda: [0, 0.0])  # device kernel name -> [launches, s]
    for k in run.trace.kernels:
        if k.step in modules:
            row = by_name[k.name]
            row[0] += 1
            row[1] += k.end - k.start
    bound = device = 0.0
    for name in kernels:
        launches, n_bytes, n_ops = totals.get(name, (0, 0.0, 0.0))
        names = run.costs[name].KERNELS
        rows = [r for kn, r in by_name.items() if any(trace_mod.kernel_matches(kn, n) for n in names)]
        traced = sum(r[0] for r in rows)
        if traced != launches:
            print(f"roofline: {name}: {traced} launches in the trace, {launches} recorded",
                  file=sys.stderr)
            return None
        if launches:
            b, d = peaks.bound_s(n_bytes, n_ops), sum(r[1] for r in rows)
            print(f"roofline: {name}: {launches} launches, bound {b * 1e3:.4f} ms, device "
                  f"{d * 1e3:.4f} ms, {100 * b / d:.2f} %", file=sys.stderr)
            bound += b
            device += d
    return 100.0 * bound / device if device > 0 else None
