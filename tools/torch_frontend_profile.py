"""Where the PyTorch/CUDA front end spends its time, on one GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_frontend_profile.py [--root DIR]

Drives the full-width kitti_hdl64 front end (scaloam_tpu_torch) over the
synthetic HDL-64 drive of chip_smoke.py and reports:
  - per-stage wall time (features, odometry, mapping, gate + keyframe
    prep), each stage ended by torch.cuda.synchronize(), mean over the
    frames after the first two;
  - per-stage kernel launches: each stage of three steady frames run
    under its own torch.profiler session, CUDA kernels counted, mean per
    frame;
  - a torch.profiler window over three steady frames: device time per
    frame (sum of kernel times), kernel launches per frame, the device's
    idle share of the wall time, and the ops with the most device time.
The last line of standard output is one JSON object with these numbers.
--root DIR imports scaloam_tpu_torch from another checkout (DIR), so two
versions can be profiled on one card in one run.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 10


def _dev_time(evt):
    """Self device time (us) of a profiler entry, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main(argv) -> int:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    if argv[:1] == ["--root"] and len(argv) == 2:
        root = argv[1]
    elif argv:
        print("usage: torch_frontend_profile.py [--root DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
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
    print(f"card: {smi}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"package {os.path.dirname(frontend.__file__)}", flush=True)
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

    from torch.profiler import ProfilerActivity, profile

    def gate_prep(st, feats, m_out):
        gate, fire = pipeline.gate_step(st.gate, m_out.pose.quat, m_out.pose.trans,
                                        cfg.pgo.keyframe_meter_gap, cfg.pgo.keyframe_deg_gap)
        if bool(fire):
            pipeline._prepare_keyframe(feats.full.xyz, feats.full.mask, feats.full.rel_time, cfg)
        return gate, fire

    def run_stages(st, scan, wrap):
        """One frontend_step, stage by stage, each called through wrap(name, fn)."""
        feats = wrap("features", lambda: features.extract_features(scan, cfg))
        o_state, o_out = wrap("odometry", lambda: odometry.odometry_step(st.o, feats, cfg))
        m_state, m_out = wrap("mapping", lambda: mapping.mapping_step(
            st.m, o_out.world, o_state.last_corner, o_state.last_surf, cfg))
        gate, fire = wrap("gate_prep", lambda: gate_prep(st, feats, m_out))
        return frontend.FrontendState(o=o_state, m=m_state, gate=gate), bool(fire)

    state = frontend.init_state(cfg, dev)
    stages = {"features": [], "odometry": [], "mapping": [], "gate_prep": []}
    fired = []
    for i, scan in enumerate(dev_scans):
        times = {}

        def timed(name, fn):
            t0 = sync_t()
            out = fn()
            times[name] = (sync_t() - t0) * 1e3
            return out

        state, fire = run_stages(state, scan, timed)
        if i >= 2:
            for k in stages:
                stages[k].append(times[k])
            fired.append(fire)
    stage_ms = {k: float(np.mean(v)) for k, v in stages.items()}
    prep_fire = [v for v, f in zip(stages["gate_prep"], fired) if f]
    print("stage ms (mean, frames 2+): " + json.dumps(stage_ms), flush=True)
    print(f"gate+prep on keyframe frames: {np.mean(prep_fire) if prep_fire else float('nan'):.3f} ms",
          flush=True)

    # ---- kernel launches per stage: each stage in its own profiler session
    state = frontend.init_state(cfg, dev)
    for scan in dev_scans[:3]:
        state, _ = run_stages(state, scan, lambda name, fn: fn())
    counts = {k: 0 for k in stages}

    def counted(name, fn):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            out = fn()
            torch.cuda.synchronize()
        counts[name] += sum(1 for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        return out

    for scan in dev_scans[3:6]:
        state, _ = run_stages(state, scan, counted)
    stage_launches = {k: v / 3 for k, v in counts.items()}
    print("kernel launches per frame by stage (frames 3-5): " + json.dumps(stage_launches),
          flush=True)

    # ---- profiler window over three steady frames of FrontEnd.step

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
        "card": smi, "stage_ms": stage_ms, "stage_launches_per_frame": stage_launches,
        "prep_on_keyframe_ms": float(np.mean(prep_fire)) if prep_fire else None,
        "profiled_wall_ms_per_frame": wall_ms, "device_ms_per_frame": device_ms,
        "kernels_per_frame": launches, "idle_share": 1 - device_ms / wall_ms,
        "top_ops": [{"op": e.key, "ms_per_frame": _dev_time(e) / 1e3 / len(window),
                     "calls_per_frame": e.count / len(window)} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
