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
backend stage's times, loops and ATE.
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
        full = chip_smoke.system_phase(torch, dev, cfg, scans, np.stack(gt), counters)
        stats = {k: full[k] for k in (
            "ms_per_frame_non_keyframe_median", "ms_per_frame_non_keyframe_mean",
            "ms_per_frame_keyframe_median", "ms_per_frame_all_mean",
            "host_syncs_per_frame_non_keyframe", "host_syncs_per_frame_keyframe", "stages",
            "keyframes", "loops", "ate_opt_m")}
        launches = full["launches"]
    else:
        stats, launches = chip_smoke.realtime_phase(torch, dev, cfg, scans, gt, counters)
    stats.update(root=root, launches=launches, probe_wall_s=time.perf_counter() - t0)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
