"""Real-time drive of the threaded runtime, alone: chip_smoke.py's phase
(d2) (the fused AsyncSlamPipeline over run.py's 160-frame synthetic loop
drive, fed at the sensor's 10 Hz) without the other phases, so two
checkouts can be compared on one card in one call; with --sync, phase (b)
instead (the same drive through SlamSystem, its backend stages timed).

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_runtime_probe.py [--sync] [--root DIR]

--root DIR imports scaloam_tpu_torch and chip_smoke.py from another
checkout (DIR). The scans are made once into build/probe_scans.npz and
reused by later runs. Prints the card's name and power limit, then one
JSON line: for (d2) scans/s, dropped frames, each worker's busy time and
frame count, optimise / ICP calls and times under threads, loops and ATE;
for (b) the non-keyframe and keyframe medians, host syncs a frame, each
backend stage's times, loops and ATE, and the keyframe frames sorted by
what their backend ran (an optimise, a loop verification, both, neither),
each kind's median frame ms beside its optimise's and verification's.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
SCANS = os.path.join(HERE, "build", "probe_scans.npz")


def main(argv) -> int:
    root, sync = HERE, argv[:1] == ["--sync"]
    argv = argv[1:] if sync else argv
    if argv[:1] == ["--root"] and len(argv) == 2:
        root = argv[1]
    elif argv:
        print("usage: torch_runtime_probe.py [--sync] [--root DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_runtime_probe: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if os.path.exists(SCANS):
        z = np.load(SCANS)
        n = len(z["gt"])
        scans, gt = [z[f"s{i}"] for i in range(n)], list(z["gt"])
    else:
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
            drive = pool.map(chip_smoke._scan_job, range(chip_smoke.SYS_FRAMES))
        scans, gt = [p for p, _ in drive], [T for _, T in drive]
        os.makedirs(os.path.dirname(SCANS), exist_ok=True)
        np.savez(SCANS, gt=np.stack(gt), **{f"s{i}": p for i, p in enumerate(scans)})
    dev = torch.device("cuda")
    cfg = config.kitti_hdl64()
    cfg = cfg.replace(pgo=dataclasses.replace(cfg.pgo, keyframe_meter_gap=1.0))
    counters = (selection.select_features, gn_odometry.associate_and_solve,
                gn_odometry.gn_solve_prepared)
    t0 = time.perf_counter()
    if sync:
        with frame_kinds() as kinds:
            full = chip_smoke.system_phase(torch, dev, cfg, scans, np.stack(gt), counters)
        stats = {k: full[k] for k in (
            "ms_per_frame_non_keyframe_median", "ms_per_frame_non_keyframe_mean",
            "ms_per_frame_keyframe_median", "ms_per_frame_all_mean",
            "host_syncs_per_frame_non_keyframe", "host_syncs_per_frame_keyframe", "stages",
            "keyframes", "loops", "ate_opt_m")}
        stats["keyframe_frames"] = kinds.summary()
        launches = full["launches"]
    else:
        stats, launches = chip_smoke.realtime_phase(torch, dev, cfg, scans, gt, counters)
    stats.update(root=root, launches=launches, probe_wall_s=time.perf_counter() - t0)
    print(json.dumps(stats), flush=True)
    return 0


class frame_kinds:
    """While open, each SlamSystem.process_scan call is timed (wall ms, as
    phase (b) times it) and sorted by what its backend ran: an optimise, a
    loop verification, both or neither; `summary` gives each kind's frame
    count and median ms, with the median ms of the optimise and the
    verification in those frames, the keyframe frames only (frame 0 and 1
    left out, as (b)'s medians)."""

    def __init__(self):
        self.frames = []

    def __enter__(self):
        import torch

        from scaloam_tpu_torch.models import pipeline, posegraph

        self.saved = (pipeline.SlamSystem.process_scan, pipeline.SlamSystem._icp_verify,
                      posegraph.optimize)
        scan, verify, optimize = self.saved
        ran = {"optimise": [], "verify": []}

        def timed(key, fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                ran[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        def process_scan(system, *a, **k):
            ran["optimise"].clear()
            ran["verify"].clear()
            t0 = time.perf_counter()
            r = scan(system, *a, **k)
            self.frames.append(((time.perf_counter() - t0) * 1e3, r.is_keyframe,
                                sum(ran["optimise"]), len(ran["optimise"]),
                                sum(ran["verify"]), len(ran["verify"])))
            return r

        pipeline.SlamSystem.process_scan = process_scan
        pipeline.SlamSystem._icp_verify = timed("verify", verify)
        posegraph.optimize = timed("optimise", optimize)
        return self

    def __exit__(self, *exc):
        from scaloam_tpu_torch.models import pipeline, posegraph

        (pipeline.SlamSystem.process_scan, pipeline.SlamSystem._icp_verify,
         posegraph.optimize) = self.saved

    def summary(self) -> dict:
        import numpy as np

        out = {}
        kinds = {"optimise only": (True, False), "verify and optimise": (True, True),
                 "verify only": (False, True), "neither": (False, False)}
        frames = [f for i, f in enumerate(self.frames) if i >= 2 and f[1]]
        for name, (opt, ver) in kinds.items():
            sel = [f for f in frames if (f[3] > 0) == opt and (f[5] > 0) == ver]
            med = lambda xs: float(np.median(xs)) if xs else None
            out[name] = dict(frames=len(sel), frame_ms_median=med([f[0] for f in sel]),
                             optimise_ms_median=med([f[2] for f in sel if f[3]]),
                             verify_ms_median=med([f[4] for f in sel if f[5]]),
                             rest_ms_median=med([f[0] - f[2] - f[4] for f in sel]))
        return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
