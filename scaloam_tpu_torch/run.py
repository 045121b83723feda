"""Command-line runner of the PyTorch/CUDA port (counterpart of
scaloam_tpu/run.py): SlamSystem, stage after stage, over a dataset or a synthetic
drive, artifacts in --out, one JSON result line on standard output.

Examples:
  python -m scaloam_tpu_torch.run --preset kitti_hdl64 --kitti-dir /data/kitti/05 \
      --poses /data/kitti/poses/05.txt --out out05
  python -m scaloam_tpu_torch.run --preset mulran_os1_64 --mulran-dir /data/Riverside01 \
      --out riv01 --use-gps
  python -m scaloam_tpu_torch.run --preset kitti_hdl64 --synthetic 120 --out synth

It runs on `cuda` unless --device names another device (`--device cpu`
runs the plain PyTorch versions); without a GPU and without --device it
exits with code 2. --async-pipeline runs the threaded real-time runtime
(runtime/pipeline.py) instead of the sync driver, and its result line adds
`dropped_frames`. --backend-device N runs the backend (pose graph,
ScanContext, loop verification) on the card cuda:N; an index past the
cards present exits with code 2. At exit it prints the process's counters
(`utils.metrics.GLOBAL`: keyframes, loops proposed and accepted) to
standard error as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SC-A-LOAM on PyTorch/CUDA")
    p.add_argument("--preset", default="kitti_hdl64",
                   choices=["kitti_hdl64", "mulran_os1_64", "vlp16", "hdl32"])
    p.add_argument("--kitti-dir", help="KITTI sequence dir (times.txt, velodyne/)")
    p.add_argument("--poses", help="KITTI ground-truth pose file (for ATE)")
    p.add_argument("--mulran-dir", help="MulRan sequence dir")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run N synthetic frames instead of a dataset")
    p.add_argument("--synthetic-radius", type=float, default=30.0,
                   help="synthetic circle radius (2*pi*r frames close the loop)")
    p.add_argument("--synthetic-course", default="circle", choices=["circle", "figure8"],
                   help="circle (single loop) or figure8 (multi-loop, angled crossings)")
    p.add_argument("--out", help="artifact output directory")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--use-gps", action="store_true", help="feed MulRan GPS altitude factors")
    p.add_argument("--resume", help="resume from a saved session directory")
    p.add_argument("--async-pipeline", action="store_true",
                   help="threaded real-time pipeline instead of the sync driver")
    p.add_argument("--backend-device", type=int, default=None,
                   help="CUDA device index for the backend stage")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' runs the "
                        "plain PyTorch versions)")
    p.add_argument("--no-live", action="store_true",
                   help="do not write the live.html trajectory view into --out")
    p.add_argument("--sc-dist-thres", type=float, default=None)
    p.add_argument("--keyframe-gap", type=float, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from scaloam_tpu_torch import config, device as device_mod
    from scaloam_tpu_torch.models.pipeline import SlamSystem
    from scaloam_tpu_torch.utils.evaluation import ate_rmse
    from scaloam_tpu_torch.utils.metrics import GLOBAL
    from scaloam_tpu_torch.utils.timing import StageTimer

    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2

    cfg = config.PRESETS[args.preset]()
    if args.sc_dist_thres is not None:
        cfg = cfg.replace(scancontext=dataclasses.replace(
            cfg.scancontext, dist_threshold=args.sc_dist_thres))
    if args.keyframe_gap is not None:
        cfg = cfg.replace(pgo=dataclasses.replace(cfg.pgo, keyframe_meter_gap=args.keyframe_gap))

    # -- data source ---------------------------------------------------------
    gt_poses = None
    if args.kitti_dir:
        from scaloam_tpu_torch.io.kitti import KittiSequence

        seq = KittiSequence(args.kitti_dir, args.poses, args.max_frames)
        frames = iter(seq)
        gt_poses = seq.gt_poses
    elif args.mulran_dir:
        from scaloam_tpu_torch.io.mulran import MulranSequence

        seq = MulranSequence(args.mulran_dir, args.max_frames)
        frames = iter(seq)
    elif args.synthetic:
        from scaloam_tpu_torch.utils import synthetic

        world = synthetic.make_world(seed=0, n_boxes=60, extent=70.0)
        if args.synthetic_course == "figure8":
            scans, gt = synthetic.simulate_trajectory_figure8(
                world, n_frames=args.synthetic, speed=1.0, scale=args.synthetic_radius,
                n_azimuth=1024, n_scans=cfg.sensor.n_scans, lidar_type=cfg.sensor.lidar_type)
        else:
            scans, gt = synthetic.simulate_trajectory(
                world, n_frames=args.synthetic, speed=1.0, radius=args.synthetic_radius,
                n_azimuth=1024, n_scans=cfg.sensor.n_scans, lidar_type=cfg.sensor.lidar_type)
        frames = ((0.1 * i, s) for i, s in enumerate(scans))
        gt_poses = gt
    else:
        print("need --kitti-dir, --mulran-dir or --synthetic", file=sys.stderr)
        return 2

    # -- run -----------------------------------------------------------------
    backend_dev = None
    if args.backend_device is not None:
        import torch

        n_cards = torch.cuda.device_count()
        if not 0 <= args.backend_device < n_cards:
            print(f"--backend-device {args.backend_device} out of range "
                  f"({n_cards} CUDA devices)", file=sys.stderr)
            return 2
        backend_dev = torch.device("cuda", args.backend_device)

    if args.resume:
        sys_ = SlamSystem.resume(args.resume, cfg, device=dev, backend_device=backend_dev)
        print(f"resumed {len(sys_.keyframes)} keyframes from {args.resume}", file=sys.stderr)
    else:
        sys_ = SlamSystem(cfg, device=dev, backend_device=backend_dev)
    if args.use_gps and args.mulran_dir:
        for t, alt in seq.gps_events():
            sys_.add_gps(t, alt)
    if args.out:
        # Flush artifacts every optimize cycle: a killed run leaves a
        # resumable session.
        sys_.attach_session_writer(args.out, live=not args.no_live)

    # A frame's sample ends once the front end's card and the backend's have
    # run its work.
    timer = StageTimer(budget_ms=cfg.runtime.stage_budget_ms,
                       devices=(sys_.device, sys_.backend_device))
    n = 0
    t_start = time.time()
    if args.async_pipeline:
        # Threaded real-time pipeline: stages overlap, backlog drops under
        # overload (the reference's live topology).
        from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline

        pipe = AsyncSlamPipeline(cfg, system=sys_)
        pipe.start()
        for t, pts in frames:
            pipe.feed(t, np.asarray(pts[:, :3], np.float32))
            n += 1
        pipe.finish()
    else:
        for t, pts in frames:
            with timer.stage("frame"):
                sys_.process_scan(np.asarray(pts[:, :3], np.float32), time=t)
            n += 1
            if n % 50 == 0:
                print(f"frame {n}: keyframes={len(sys_.keyframes)} "
                      f"loops={len(sys_.loops_found)} "
                      f"mean={timer.mean_ms('frame'):.0f} ms", file=sys.stderr)
    wall = time.time() - t_start

    # The odometry's degenerate-frame count, read once per run.
    n_degen = int(sys_.o_state.degenerate_count)
    if n_degen:
        print(f"WARNING: {n_degen} frames had fewer than "
              f"{cfg.odometry.min_correspondences} odometry correspondences", file=sys.stderr)

    result = {
        "frames": n,
        "keyframes": len(sys_.keyframes),
        "loops": len(sys_.loops_found),
        "scans_per_sec": round(n / max(wall, 1e-9), 2),
        "degenerate_frames": n_degen,
    }
    if args.async_pipeline:
        result["dropped_frames"] = pipe.dropped_frames
    if args.out:
        sys_.save_session(args.out)
        result["out"] = args.out

    if gt_poses is not None and len(sys_.keyframes) > 2:
        est = sys_.optimized_poses()
        odom = sys_.odometry_keyframe_poses()
        gt0 = np.linalg.inv(gt_poses[0])
        gt_rel = np.stack([gt0 @ g for g in gt_poses])
        # Keyframes pair with ground truth by their source frame; resumed
        # keyframes without one by nearest position.
        kf_frames = [
            kf.frame if 0 <= kf.frame < len(gt_rel) else int(np.argmin(
                np.linalg.norm(gt_rel[:, :3, 3] - odom[k, :3, 3], axis=-1)))
            for k, kf in enumerate(sys_.keyframes)
        ]
        gt_kf = gt_rel[kf_frames]
        result["ate_rmse_optimized"] = round(ate_rmse(est, gt_kf), 4)
        result["ate_rmse_odometry"] = round(ate_rmse(odom, gt_kf), 4)

    print(f"counters: {GLOBAL.json_line()}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
