"""Where the PyTorch/CUDA front end spends its time, on one GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_frontend_profile.py

Drives the full-width kitti_hdl64 front end (scaloam_tpu_torch) over the
synthetic HDL-64 drive of chip_smoke.py and reports:
  - per-stage wall time (features, odometry, mapping, gate + keyframe
    prep), each stage ended by torch.cuda.synchronize(), mean over the
    frames after the first two;
  - a torch.profiler window over three steady frames: device time per
    frame (sum of kernel times), kernel launches per frame, the device's
    idle share of the wall time, and the ops with the most device time.
The last line of standard output is one JSON object with these numbers.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

N_FRAMES = 10


def _dev_time(evt):
    """Self device time (us) of a profiler entry, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_frontend_profile: no CUDA device available", file=sys.stderr)
        return 2

    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import frontend, mapping, odometry, pipeline
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import _build
    from scaloam_tpu_torch.types import LidarScan
    from scaloam_tpu_torch.utils import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}  torch {torch.__version__}  cuda {torch.version.cuda}", flush=True)
    _build.build()
    cfg = config.kitti_hdl64()
    dev = torch.device("cuda")
    world = synthetic.make_world(seed=3, n_boxes=60, extent=70.0)
    scans, _ = synthetic.simulate_trajectory(
        world, n_frames=N_FRAMES, speed=1.2, radius=40.0, n_scans=64,
        n_azimuth=2048, seed=7,
    )
    dev_scans = [LidarScan.from_numpy(s, cfg.sensor.max_points, dev) for s in scans]

    # ---- per-stage wall time (the stages of frontend.frontend_step)
    def sync_t():
        torch.cuda.synchronize()
        return time.perf_counter()

    state = frontend.init_state(cfg, dev)
    stages = {"features": [], "odometry": [], "mapping": [], "gate_prep": []}
    fired = []
    for i, scan in enumerate(dev_scans):
        t0 = sync_t()
        feats = features.extract_features(scan, cfg)
        t1 = sync_t()
        o_state, o_out = odometry.odometry_step(state.o, feats, cfg)
        t2 = sync_t()
        m_state, m_out = mapping.mapping_step(state.m, o_out.world, o_state.last_corner,
                                              o_state.last_surf, cfg)
        t3 = sync_t()
        gate, fire = pipeline.gate_step(state.gate, m_out.pose.quat, m_out.pose.trans,
                                        cfg.pgo.keyframe_meter_gap, cfg.pgo.keyframe_deg_gap)
        if bool(fire):
            pipeline._prepare_keyframe(feats.full.xyz, feats.full.mask, feats.full.rel_time, cfg)
        t4 = sync_t()
        state = frontend.FrontendState(o=o_state, m=m_state, gate=gate)
        if i >= 2:
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[k].append(dt * 1e3)
            fired.append(bool(fire))
    stage_ms = {k: float(np.mean(v)) for k, v in stages.items()}
    prep_fire = [v for v, f in zip(stages["gate_prep"], fired) if f]
    print("stage ms (mean, frames 2+): " + json.dumps(stage_ms), flush=True)
    print(f"gate+prep on keyframe frames: {np.mean(prep_fire) if prep_fire else float('nan'):.3f} ms",
          flush=True)

    # ---- profiler window over three steady frames of FrontEnd.step
    from torch.profiler import ProfilerActivity, profile

    fe = frontend.FrontEnd(cfg, device="cuda")
    for scan in dev_scans[:3]:
        fe.step(scan.xyz, scan.mask)
    torch.cuda.synchronize()
    window = dev_scans[3:6]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan in window:
            fe.step(scan.xyz, scan.mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / len(window)
    launches = len(kernels) / len(window)
    top = sorted(prof.key_averages(), key=_dev_time, reverse=True)[:15]
    print(f"profiled: wall {wall_ms:.2f} ms/frame, device {device_ms:.2f} ms/frame, "
          f"{launches:.0f} kernels/frame, idle share {1 - device_ms / wall_ms:.3f}", flush=True)
    for e in top:
        print(f"  {_dev_time(e) / 1e3 / len(window):8.3f} ms/frame  {e.count / len(window):7.1f} calls/frame  {e.key[:80]}")

    print(json.dumps({
        "card": smi, "stage_ms": stage_ms,
        "prep_on_keyframe_ms": float(np.mean(prep_fire)) if prep_fire else None,
        "profiled_wall_ms_per_frame": wall_ms, "device_ms_per_frame": device_ms,
        "kernels_per_frame": launches, "idle_share": 1 - device_ms / wall_ms,
        "top_ops": [{"op": e.key, "ms_per_frame": _dev_time(e) / 1e3 / len(window),
                     "calls_per_frame": e.count / len(window)} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
