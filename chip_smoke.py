"""Chip smoke test of the PyTorch/CUDA port (scaloam_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from scaloam_tpu_torch/csrc with
nvcc, holds each kernel entry against its plain PyTorch version on the
card at the shapes of a full-width kitti_hdl64 frame (K1 selection; K2's
odometry entry A and its prepared-factor entry B, which mapping calls),
then drives the port's paths, each with the kernels' launch counts set
to 0 just before it and read just after:

- the front end (features -> odometry -> mapping -> keyframe gate)
  through `FrontEnd(kitti_hdl64(), device="cuda")` over 12 frames of a
  synthetic HDL-64 drive, poses checked against its ground truth;
- (a) the pose graph at users' sizes: `optimize` on drifted synthetic
  circle chains at 1024 nodes / 16 loops (held against the same function
  on the CPU), 4096 / 64 (the Woodbury tier) and 8192 / 256 (the large
  chain-CG tier), three warm-started optimise ticks each, ATE to the
  ground truth at most half the drifted chain's;
- (b) the system: `SlamSystem(kitti_hdl64() with a 1 m keyframe gap,
  device="cuda")` over the 160-frame synthetic loop drive of run.py's
  synthetic source, which must close a loop, with the backend's stages
  timed, their host reads counted and one call of each profiled for its
  kernel launches;
- (c) the CLI: `scaloam_tpu_torch.run.main` on a 16-frame synthetic drive
  into build/smoke_session, then resumed from it, and with
  --async-pipeline into build/smoke_async;
- (d1) the threaded runtime `AsyncSlamPipeline`, fused and then separate,
  over the first 48 frames of (b)'s drive fed at once: no frame dropped,
  every frame's odometry within 1e-3 m of (b)'s and the same keyframes;
- (d2) the fused runtime over all 160 frames fed at the sensor's 10 Hz:
  scans/s, drops, stage busy times, optimise and ICP times under threads,
  at least one loop verified and the optimised keyframes' ATE;
- (e) the de-skew path: 8 skewed full-width frames (accelerating, the
  reference's tests/test_deskew.py scene) through features + odometry_step
  with distortion off and on; de-skewed error bounds, K2 entry A gated off.

The last three lines of standard output are the kernel table (JSON, with
the launches of the system drive), the card's name and power limit, and
the device line (JSON). Any mismatch or error raises, so the exit code is
non-zero. Without a GPU it exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings

import numpy as np

N_FRAMES = 12
WARM_FRAMES = 2  # excluded from the ms/frame window
PREP_FRAME = 3  # frame whose mapping factors feed entry B's check (dense map)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
K2_QUAT_TOL = 2e-4  # f32 summation order differs from the plain version
K2_TRANS_TOL = 2e-3
MAX_TRANS_ERR_M = 0.5  # sanity bound on the mapped pose vs ground truth
# Operations per point counted from csrc/gn_odometry.cu (mul, add, compare,
# sqrt and divide each count one): the association of a corner / surf
# point (the surf's plane normal included), and one GN iteration of a valid
# corner / surf factor.
K2_OPS_ASSOC = (55, 105)
K2_OPS_ITER = (300, 140)
# (a) pose graph: (nodes, loops) per tier, optimise ticks per tier, and the
# tier held against the CPU run of the same function.
PGO_TIERS = ((1024, 16), (4096, 64), (8192, 256))
PGO_TICKS = 3
PGO_CPU_TIER = 1024
PGO_CPU_TOL_M = 1e-3
# (b) the system drive: run.py's synthetic source, 160 frames.
SYS_FRAMES = 160
SYS_ATE_MAX_M = 0.5  # tests/test_pipeline_e2e.py's bounds
SYS_ATE_VS_ODOM = 1.5
PROFILE_CALL = 3  # the call of a state-changing backend stage that is profiled
CLEAN_FRAMES = 30  # frames of the uninstrumented SlamSystem-vs-FrontEnd timing
# (d1)/(d2) the threaded runtime over (b)'s scans.
ASYNC_FRAMES = 48  # < the queue depth of 100, so nothing drops when fed at once
ASYNC_ODOM_TOL_M = 1e-3
SENSOR_PERIOD_S = 0.1
# (e) de-skew: tests/test_deskew.py's scene and bounds.
DESKEW_FRAMES = 8
DESKEW_MAX_ERR_M = 0.06
DESKEW_VS_PLAIN = 0.55


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over `iters` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device ms per call: `iters` calls captured in one CUDA graph and
    replayed, so the host's launch cost (the wrappers' checks and the
    ctypes call) does not hide the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound_ms(n_bytes: int, n_ops: int):
    """(least time on the card in ms, what sets it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def pose_err(torch, label, got, want, counts=None):
    """Max |dq|, |dt| of kernel vs plain (quaternion sign aligned); raises
    past the K2 tolerances or on unequal counts."""
    q, t = got
    qp, tp = want
    if torch.dot(q, qp) < 0:
        q = -q
    dq = float((q - qp).abs().max())
    dt = float((t - tp).abs().max())
    same = counts is None or counts[0] == counts[1]
    if not same or not (dq <= K2_QUAT_TOL and dt <= K2_TRANS_TOL):
        raise AssertionError(f"{label}: kernel {q.tolist()} {t.tolist()} vs plain "
                             f"{qp.tolist()} {tp.tolist()}, counts {counts}")
    log(f"{label}: {'' if counts is None else f'counts {counts[0]} equal, '}"
        f"|dq| {dq:.2e} (tol {K2_QUAT_TOL}), |dt| {dt:.2e} (tol {K2_TRANS_TOL})")
    return max(dq, dt)


def _scan_job(i):
    """Frame i of run.py's synthetic drive (simulate_trajectory's circle,
    radius 22 m, 1 m a frame, 1024 azimuths) and its ground-truth pose."""
    from scaloam_tpu_torch.utils import synthetic

    world = synthetic.make_world(seed=0, n_boxes=60, extent=70.0)
    theta = i / 22.0
    pos = np.array([22.0 * np.sin(theta), 22.0 * (1 - np.cos(theta)), 1.8])
    pts = synthetic.simulate_scan(world, pos, theta, n_scans=64, n_azimuth=1024, seed=i,
                                  lidar_type="HDL64")
    T = np.eye(4)
    T[:3, :3] = [[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0], [0, 0, 1]]
    T[:3, 3] = pos
    return pts, T


def _deskew_scans():
    """tests/test_deskew.py's skewed, accelerating drive: scans and the
    ground truth at each sweep's start."""
    from scaloam_tpu_torch.utils import synthetic

    return synthetic.simulate_trajectory(
        synthetic.make_world(seed=3), n_frames=DESKEW_FRAMES, speed=0.6, radius=30.0,
        n_azimuth=900, seed=10, skew=True, accel=0.25)


def circle_chain(n, n_loops, seed, lap=512, step=1.0, bias=5e-6, s_rot=1e-5, s_trans=2e-3):
    """A planar drive of n nodes around one circle of `lap` nodes, lap
    after lap. Odometry: the true increments plus a heading bias and
    noise. Loops: node (L * lap + j) to node j, spread over the later laps,
    with identity measurements. Returns (gt [n, 3], odom quat [n, 4], odom
    trans [n, 3], loops [(i, j)])."""
    alpha = 2 * np.pi / lap
    R = step / (2 * np.sin(alpha / 2))
    th = alpha * np.arange(n)
    gt = np.stack([R * np.sin(th), R * (1 - np.cos(th)), np.zeros(n)], 1)
    rng = np.random.default_rng(seed)
    chord = np.array([R * np.sin(alpha), R * (1 - np.cos(alpha))])
    phi = np.concatenate([[0.0], np.cumsum(alpha + bias + rng.normal(0, s_rot, n - 1))])
    d = chord[None] + rng.normal(0, s_trans, (n - 1, 2))
    c, s = np.cos(phi[:-1]), np.sin(phi[:-1])
    steps = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1]], 1)
    pos = np.concatenate([[[0.0, 0.0]], np.cumsum(steps, 0)])
    odom_t = np.concatenate([pos, np.zeros((n, 1))], 1).astype(np.float32)
    z = np.zeros(n)
    odom_q = np.stack([np.cos(phi / 2), z, z, np.sin(phi / 2)], 1).astype(np.float32)
    laps = n // lap
    stride = max(1, (lap * (laps - 1)) // n_loops)
    loops = [(L * lap + j, j) for L in range(1, laps) for j in range(0, lap, stride)][:n_loops]
    return gt, odom_q, odom_t, loops


def build_graph(torch, pg, Pose, cfg, odom_q, odom_t, loops, dev):
    g = pg.init_graph(cfg, dev, initial_nodes=len(odom_q), initial_loops=len(loops))
    q, t = torch.from_numpy(odom_q).to(dev), torch.from_numpy(odom_t).to(dev)
    for k in range(len(odom_q)):
        g = pg.add_keyframe(g, Pose(q[k], t[k]), 0.0, False, n_nodes=k)
    ident = Pose.identity(dev)
    for n, (i, j) in enumerate(loops):
        g = pg.add_loop(g, i, j, ident, n_loops=n)
    return g


def ate_m(trans, gt) -> float:
    return float(np.sqrt(np.mean(np.sum((trans[: len(gt)] - gt) ** 2, axis=1))))


def count_launches(torch, fn):
    """(fn(), CUDA kernels fn launched), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA)


class SyncCounter:
    """Counts the synchronizing CUDA operations torch reports (sync debug
    mode "warn") while active."""

    def __init__(self, torch):
        self.torch = torch
        self.seen = []

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self.seen = self._cm.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(*exc)

    def count(self) -> int:
        return sum(1 for w in self.seen if "synchroniz" in str(w.message))


class Stage:
    """Wraps a callable: each call is timed between device syncs and its
    host syncs counted (the counter must be active). Call `profile_at` is
    profiled for its kernel launches instead and left out of the times;
    a stage without one (a call that changes no state) is profiled by
    `replay` on its last call's arguments."""

    def __init__(self, torch, name, fn, syncs: SyncCounter, profile_at=None):
        self.torch, self.name, self.fn, self.syncs = torch, name, fn, syncs
        self.profile_at = profile_at
        self.ms, self.sync_counts, self.launches, self.last = [], [], None, None
        self.profiled_calls = 0  # calls of the drive that were profiled, not timed

    def __call__(self, *a, **k):
        torch = self.torch
        torch.cuda.synchronize()
        if self.launches is None and len(self.ms) == self.profile_at:
            out, self.launches = count_launches(torch, lambda: self.fn(*a, **k))
            self.profiled_calls += 1
            return out
        self.last = (a, k)
        n0 = self.syncs.count()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        n1 = self.syncs.count()
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.sync_counts.append(n1 - n0)
        return out

    def replay(self):
        if self.launches is None and self.last is not None:
            a, k = self.last
            _, self.launches = count_launches(self.torch, lambda: self.fn(*a, **k))

    def summary(self) -> dict:
        ms = np.asarray(self.ms)
        return {"calls": len(self.ms) + self.profiled_calls,
                "ms_mean": float(ms.mean()) if len(ms) else None,
                "ms_median": float(np.median(ms)) if len(ms) else None,
                "ms_max": float(ms.max()) if len(ms) else None,
                "host_syncs_mean": float(np.mean(self.sync_counts)) if self.sync_counts else None,
                "launches": self.launches}


def pose_graph_phase(torch, dev, tiers=PGO_TIERS):
    """(a): optimise ticks on the circle chains; returns a row per tier."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.types import Pose

    rows = []
    for n, nl in tiers:
        gt, oq, ot, loops = circle_chain(n, nl, seed=n)
        cfg = dataclasses.replace(config.PGOConfig(), max_keyframes=n, max_loops=nl,
                                  loop_variance=1e-3, cauchy_k=100.0)
        g = build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev)
        drift = ate_m(ot, gt)
        ticks = []
        for tick in range(PGO_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = pg.optimize(g, cfg)
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)
            if tick == 0 and n == PGO_CPU_TIER:
                g_cpu = pg.optimize(build_graph(torch, pg, Pose, cfg, oq, ot, loops, "cpu"), cfg)
                diff = float((g.poses.trans.cpu() - g_cpu.poses.trans).abs().max())
                if not diff <= PGO_CPU_TOL_M:
                    raise AssertionError(f"pose graph {n}: card vs CPU {diff:.2e} m")
                log(f"pose graph {n}: card vs CPU after one optimise: max |dt| {diff:.2e} m "
                    f"(tol {PGO_CPU_TOL_M})")
        trans = g.poses.trans.cpu().numpy()
        if not (np.isfinite(trans).all() and np.isfinite(g.poses.quat.cpu().numpy()).all()):
            raise AssertionError(f"pose graph {n}: non-finite poses")
        opt = ate_m(trans, gt)
        if not opt <= 0.5 * drift:
            raise AssertionError(f"pose graph {n}: ATE {opt:.3f} m > half the drift {drift:.3f} m")
        _, launches = count_launches(torch, lambda: pg.optimize(g, cfg))
        with SyncCounter(torch) as sc:
            pg.optimize(g, cfg)
            syncs = sc.count()
        row = {"nodes": n, "loops": nl, "woodbury": pg.uses_woodbury(n, nl, cfg),
               "ms_per_optimise": ticks, "launches_per_optimise": launches,
               "host_syncs_per_optimise": syncs, "ate_drift_m": drift, "ate_opt_m": opt}
        log(f"pose graph {n} nodes / {nl} loops ({'Woodbury' if row['woodbury'] else 'chain-CG'}): "
            f"ms per optimise {[round(x, 2) for x in ticks]}, {launches} launches, "
            f"{syncs} host syncs, ATE {drift:.4f} -> {opt:.4f} m")
        rows.append(row)
    return rows


def system_phase(torch, dev, cfg, scans, gt, launch_counters):
    """(b): the drive through SlamSystem(cfg); returns the stats."""
    from scaloam_tpu_torch.models import pipeline, posegraph
    from scaloam_tpu_torch.utils.evaluation import ate_rmse

    s = pipeline.SlamSystem(cfg, device=dev)
    syncs = SyncCounter(torch)
    stages = {
        "keyframe prep": Stage(torch, "keyframe prep", pipeline._prepare_keyframe, syncs),
        "sc make": Stage(torch, "sc make", s.sc.make_and_save, syncs, profile_at=PROFILE_CALL),
        "sc detect": Stage(torch, "sc detect", s.sc.detect_loop_closure_id, syncs),
        "graph append": Stage(torch, "graph append", posegraph.add_keyframe, syncs,
                              profile_at=PROFILE_CALL),
        "icp verify": Stage(torch, "icp verify", s._icp_verify, syncs),
        "optimise": Stage(torch, "optimise", posegraph.optimize, syncs),
    }
    orig = (pipeline._prepare_keyframe, posegraph.add_keyframe, posegraph.optimize)
    pipeline._prepare_keyframe = stages["keyframe prep"]
    posegraph.add_keyframe = stages["graph append"]
    posegraph.optimize = stages["optimise"]
    s.sc.make_and_save = stages["sc make"]
    s.sc.detect_loop_closure_id = stages["sc detect"]
    s._icp_verify = stages["icp verify"]
    frame_ms, frame_syncs, kf_flags, odom_first = [], [], [], []
    for counter in launch_counters:
        counter.launches = 0
    try:
        with syncs:
            for i, pts in enumerate(scans):
                n0 = syncs.count()
                t0 = time.perf_counter()
                r = s.process_scan(pts, time=0.1 * i)
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                frame_syncs.append(syncs.count() - n0)
                kf_flags.append(r.is_keyframe)
                if i < ASYNC_FRAMES:
                    odom_first.append(r.odom_pose.trans)
        torch.cuda.synchronize()
    finally:
        pipeline._prepare_keyframe, posegraph.add_keyframe, posegraph.optimize = orig
    launches = [c.launches for c in launch_counters]
    for st in stages.values():
        st.replay()

    est, odom = s.optimized_poses(), s.odometry_keyframe_poses()
    if not (np.isfinite(est).all() and np.isfinite(odom).all()):
        raise AssertionError("system drive: non-finite keyframe poses")
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
    gt_kf = gt_rel[[kf.frame for kf in s.keyframes]]
    ate_opt, ate_odom = ate_rmse(est, gt_kf), ate_rmse(odom, gt_kf)
    if not s.loops_found:
        raise AssertionError("system drive: no loop accepted")
    if not (ate_opt < SYS_ATE_MAX_M and ate_opt <= SYS_ATE_VS_ODOM * ate_odom):
        raise AssertionError(f"system drive: ATE {ate_opt:.4f} m (odometry {ate_odom:.4f} m)")
    kf = np.asarray(kf_flags)
    ms = np.asarray(frame_ms)
    steady = np.arange(len(ms)) >= 2
    stats = {
        "frames": len(scans), "keyframes": len(s.keyframes), "loops": s.loops_found,
        "ate_opt_m": ate_opt, "ate_odom_m": ate_odom, "launches": launches,
        "ms_per_frame_non_keyframe_median": float(np.median(ms[~kf & steady])),
        "ms_per_frame_non_keyframe_mean": float(ms[~kf & steady].mean()),
        "ms_per_frame_keyframe_median": float(np.median(ms[kf & steady])),
        "ms_per_frame_all_mean": float(ms[steady].mean()),
        "host_syncs_per_frame_non_keyframe": float(np.mean(np.asarray(frame_syncs)[~kf])),
        "host_syncs_per_frame_keyframe": float(np.mean(np.asarray(frame_syncs)[kf])),
        "stages": {k: v.summary() for k, v in stages.items()},
        "odom_first": torch.stack(odom_first).cpu().numpy(),
        "keyframes_first": int(np.sum(kf[:ASYNC_FRAMES])),
    }
    return stats


def clean_frame_times(torch, dev, cfg, scans, frontend_cfg=None):
    """ms/frame of SlamSystem.process_scan (no wrappers, no sync counter)
    and of FrontEnd.step with the same host-to-device upload, over the
    same scans in one process: (system ms of non-keyframe frames, system
    ms of keyframe frames, front-end ms per frame), frames 2.. each."""
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.models.pipeline import SlamSystem
    from scaloam_tpu_torch.types import LidarScan

    s = SlamSystem(cfg, device=dev)
    sys_ms, kf = [], []
    for i, pts in enumerate(scans):
        t0 = time.perf_counter()
        r = s.process_scan(pts, time=0.1 * i)
        sys_ms.append((time.perf_counter() - t0) * 1e3)
        kf.append(r.is_keyframe)
    fe = FrontEnd(frontend_cfg or cfg, device=dev)
    fe_ms = []
    for pts in scans:
        t0 = time.perf_counter()
        fe.step(*LidarScan.from_numpy(pts, cfg.sensor.max_points, dev))
        torch.cuda.synchronize()
        fe_ms.append((time.perf_counter() - t0) * 1e3)
    sys_ms, kf = np.asarray(sys_ms[2:]), np.asarray(kf[2:])
    return sys_ms[~kf], sys_ms[kf], np.asarray(fe_ms[2:])


def cli_phase(root, extra_args=()):
    """(c): run.main on 16 synthetic frames into build/smoke_session, then
    resumed from it; returns both JSON results."""
    import shutil

    from scaloam_tpu_torch import run

    out = os.path.join(root, "build", "smoke_session")
    shutil.rmtree(out, ignore_errors=True)
    base = ["--synthetic", "16", "--keyframe-gap", "1.0", "--synthetic-radius", "25",
            *extra_args]
    results = []
    for extra in (["--out", out], ["--resume", out, "--out", out]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(base + extra)
        if rc != 0:
            raise AssertionError(f"run.main {extra}: exit code {rc}")
        results.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    names = set(os.listdir(out))
    want = {"Scans", "SCDs", "optimized_poses.txt", "odom_poses.txt",
            "singlesession_posegraph.g2o", "times.txt"}
    if not want <= names:
        raise AssertionError(f"session artifacts {sorted(names)} lack {sorted(want - names)}")
    first, resumed = results
    n_kf = resumed["keyframes"]
    if not (first["keyframes"] >= 3 and n_kf > first["keyframes"]
            and len(os.listdir(os.path.join(out, "Scans"))) == n_kf
            and len(os.listdir(os.path.join(out, "SCDs"))) == n_kf
            and len(np.loadtxt(os.path.join(out, "times.txt"))) == n_kf):
        raise AssertionError(f"CLI session: {results}")
    # the threaded runtime through the CLI
    out = os.path.join(root, "build", "smoke_async")
    shutil.rmtree(out, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(base + ["--async-pipeline", "--out", out])
    if rc != 0:
        raise AssertionError(f"run.main --async-pipeline: exit code {rc}")
    results.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    if not (results[-1]["keyframes"] >= 3 and "dropped_frames" in results[-1]):
        raise AssertionError(f"CLI --async-pipeline: {results[-1]}")
    for r in results:
        for key in ("frames", "keyframes", "loops", "scans_per_sec", "degenerate_frames", "out",
                    "ate_rmse_optimized", "ate_rmse_odometry"):
            if key not in r:
                raise AssertionError(f"CLI result lacks {key}: {r}")
    return results


def stream_sync(torch, dev):
    """Wait for the calling thread's current stream (not the device)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def timed(torch, dev, fn, sink):
    """fn, with each call's ms (to its stream's end) appended to sink."""
    def call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        stream_sync(torch, dev)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def async_phase(torch, dev, cfg, scans, sync_stats, counters, fused):
    """(d1): AsyncSlamPipeline over scans fed at once, held against the
    sync drive's odometry and keyframe count on the same frames; returns
    (stats, launches)."""
    from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline

    topo = cfg.replace(runtime=dataclasses.replace(cfg.runtime, fused_frontend=fused))
    pipe = AsyncSlamPipeline(topo, drop_backlog=False, device=dev)
    if pipe.fused != fused:
        raise AssertionError(f"async topology: fused {pipe.fused}, want {fused}")
    pipe.start()
    for counter in counters:
        counter.launches = 0
    t0 = time.perf_counter()
    for i, pts in enumerate(scans):
        pipe.feed(SENSOR_PERIOD_S * i, pts)
    pipe.finish()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    n = len(scans)
    odom = np.stack([x for _, x in pipe.odom_results]) if pipe.odom_results else np.zeros((0, 3))
    err = float(np.abs(odom - sync_stats["odom_first"][:n]).max()) if len(odom) == n else None
    stats = {"topology": "fused" if fused else "separate", "frames": n, "wall_s": wall,
             "dropped_frames": pipe.dropped_frames, "odom_results": len(pipe.odom_results),
             "mapped_results": len(pipe.mapped_results), "keyframes": len(pipe.sys.keyframes),
             "sync_keyframes": sync_stats["keyframes_first"], "max_odom_err_m": err,
             "workers_alive": pipe.workers_alive}
    if not (pipe.dropped_frames == 0 and len(pipe.odom_results) == n
            and len(pipe.mapped_results) == n and pipe.workers_alive == 0
            and len(pipe.sys.keyframes) == sync_stats["keyframes_first"]
            and err is not None and err <= ASYNC_ODOM_TOL_M):
        raise AssertionError(f"async {stats['topology']}: {stats}")
    return stats, launches


def realtime_phase(torch, dev, cfg, scans, gt, counters):
    """(d2): the fused pipeline over the whole drive, fed at the sensor
    period; returns (stats, launches)."""
    from scaloam_tpu_torch.models import posegraph
    from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline
    from scaloam_tpu_torch.utils.evaluation import ate_rmse

    pipe = AsyncSlamPipeline(cfg, device=dev)
    if not pipe.fused:
        raise AssertionError("the real-time drive runs the fused topology")
    pipe.start()
    opt_ms, icp_ms = [], []
    orig_opt = posegraph.optimize
    posegraph.optimize = timed(torch, dev, orig_opt, opt_ms)
    pipe.sys._icp_verify = timed(torch, dev, pipe.sys._icp_verify, icp_ms)
    for counter in counters:
        counter.launches = 0
    try:
        t0 = time.perf_counter()
        for i, pts in enumerate(scans):
            time.sleep(max(0.0, t0 + SENSOR_PERIOD_S * i - time.perf_counter()))
            pipe.feed(SENSOR_PERIOD_S * i, pts)
        t_fed = time.perf_counter() - t0
        pipe.finish(timeout=600.0)
        wall = time.perf_counter() - t0
    finally:
        posegraph.optimize = orig_opt
    launches = [c.launches for c in counters]
    n = len(scans)
    s = pipe.sys
    est, odom = s.optimized_poses(), s.odometry_keyframe_poses()
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
    gt_kf = gt_rel[[kf.frame for kf in s.keyframes]]
    ate = ate_rmse(est, gt_kf) if len(est) > 2 else None
    stats = {
        "frames": n, "fed_s": t_fed, "wall_s": wall, "scans_per_sec": n / wall,
        "dropped_frames": pipe.dropped_frames, "odom_results": len(pipe.odom_results),
        "mapped_results": len(pipe.mapped_results), "keyframes": len(s.keyframes),
        "loops": s.loops_found, "ate_opt_m": ate,
        "ate_odom_m": ate_rmse(odom, gt_kf) if len(odom) > 2 else None,
        "workers_alive": pipe.workers_alive,
        "optimise_calls": len(opt_ms), "optimise_ms_first": opt_ms[0] if opt_ms else None,
        "optimise_ms_median": float(np.median(opt_ms)) if opt_ms else None,
        "icp_calls": len(icp_ms), "icp_ms_median": float(np.median(icp_ms)) if icp_ms else None,
        "stage_busy_s": dict(pipe.stage_busy), "stage_frames": dict(pipe.stage_frames),
        "frontend_ms_per_frame": (1e3 * pipe.stage_busy["frontend"]
                                  / max(pipe.stage_frames["frontend"], 1)),
    }
    if not (pipe.workers_alive == 0 and len(pipe.odom_results) + pipe.scan_q.dropped == n
            and s.loops_found and ate is not None and ate < SYS_ATE_MAX_M):
        raise AssertionError(f"real-time drive: {stats}")
    return stats, launches


def deskew_phase(torch, dev, scans, gt, counters):
    """(e): features + odometry_step over the skewed frames with distortion
    off and on; returns {mode: stats}. Error: mean |rel translation - ground
    truth's forward hop| over frames 2..n-2 (tests/test_deskew.py)."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import odometry
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.types import LidarScan

    base = config.kitti_hdl64()
    out = {}
    for distortion in (False, True):
        cfg = base.replace(odometry=dataclasses.replace(base.odometry, distortion=distortion))
        state = odometry.init_state(cfg, dev)
        for counter in counters:
            counter.launches = 0
        errs, ms = [], []
        for i, pts in enumerate(scans):
            scan = LidarScan.from_numpy(pts, cfg.sensor.max_points, dev)
            stream_sync(torch, dev)
            t0 = time.perf_counter()
            state, o = odometry.odometry_step(state, features.extract_features(scan, cfg), cfg)
            rel = o.rel.trans.cpu().numpy()
            ms.append((time.perf_counter() - t0) * 1e3)
            if 2 <= i < len(scans) - 1:
                errs.append(float(np.linalg.norm(rel - (np.linalg.inv(gt[i]) @ gt[i + 1])[:3, 3])))
        out["deskew" if distortion else "plain"] = {
            "mean_rel_err_m": float(np.mean(errs)),
            "ms_per_frame_median": float(np.median(ms[2:])),
            "launches": [c.launches for c in counters]}
    d, p = out["deskew"]["mean_rel_err_m"], out["plain"]["mean_rel_err_m"]
    if not (d < DESKEW_MAX_ERR_M and d < DESKEW_VS_PLAIN * p):
        raise AssertionError(f"de-skew: {out}")
    want = {"deskew": [len(scans), 0, 0], "plain": [len(scans), len(scans) - 1, 0]}
    if any(out[k]["launches"] != want[k] for k in want):
        raise AssertionError(f"de-skew launches {out}, want K1/K2 A/K2 B {want}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import scaloam_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    # The system drive's scans are made by worker processes while the
    # kernels build and the earlier phases run.
    pool = multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1))
    try:
        drive = pool.map_async(_scan_job, range(SYS_FRAMES))
        skewed = pool.apply_async(_deskew_scans)
        return _main(torch, drive, skewed)
    finally:
        pool.terminate()
        pool.join()


def _main(torch, drive, skewed) -> int:
    t_script = time.perf_counter()

    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import odometry
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import features, se3
    from scaloam_tpu_torch.ops.kernels import _build, gn_odometry, selection
    from scaloam_tpu_torch.types import LidarScan, Pose
    from scaloam_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    smi = smi_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    log(f"card: {smi}")

    # ---- build every kernel of the path from csrc/ (parallel nvcc)
    t0 = t_checks = time.perf_counter()
    logs = _build.build()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    cfg = config.kitti_hdl64()
    cap = cfg.sensor.max_points
    feat = cfg.features
    t0 = time.perf_counter()
    world = synthetic.make_world(seed=3, n_boxes=60, extent=70.0)
    scans, gt = synthetic.simulate_trajectory(
        world, n_frames=N_FRAMES, speed=1.2, radius=40.0, n_scans=64,
        n_azimuth=2048, seed=7,
    )
    dev_scans = [LidarScan.from_numpy(s, cap, dev) for s in scans]
    torch.cuda.synchronize()
    log(f"data: {N_FRAMES} scans of {[len(s) for s in scans[:3]]}... points "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- K1: selection on a real full-width frame, the same frame as one
    # subregion spanning each row (long lists), and a tie-heavy input
    si = features.selection_inputs(dev_scans[1], cfg)
    sel_kw = dict(n_sub=feat.n_subregions, n_corner=feat.less_sharp_per_subregion,
                  n_flat=feat.flat_per_subregion, curv_thr=feat.curvature_threshold)
    frame_args = (si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep)
    row_args = (si.curv, si.left_ext, si.right_ext, si.eligible,
                si.sp[:, :1].contiguous(), si.ep[:, -1:].contiguous())
    S, W = si.curv.shape
    rng = np.random.default_rng(0)
    count = rng.integers(W // 2, W + 1, size=S)
    L = count - 11
    jsub = np.arange(feat.n_subregions)
    tie_args = (
        torch.tensor(rng.integers(0, 8, size=(S, W)) * 0.05, dtype=torch.float32, device=dev),
        torch.tensor(rng.integers(0, 6, size=(S, W)), dtype=torch.int32, device=dev),
        torch.tensor(rng.integers(0, 6, size=(S, W)), dtype=torch.int32, device=dev),
        torch.tensor((np.arange(W)[None] >= 5) & (np.arange(W)[None] <= 4 + L[:, None])
                     & (rng.uniform(size=(S, W)) < 0.9), device=dev),
        torch.tensor(5 + (L[:, None] * jsub) // 6, dtype=torch.int32, device=dev),
        torch.tensor(5 + (L[:, None] * (jsub + 1)) // 6 - 1, dtype=torch.int32, device=dev),
    )
    names = ("corner_idx", "corner_ok", "flat_idx", "flat_ok", "labels")
    k1_err = 0
    for label, args, kw in (("frame", frame_args, sel_kw), ("ties", tie_args, sel_kw),
                            ("frame n_sub=1", row_args, dict(sel_kw, n_sub=1))):
        got = selection.select_features(*args, **kw)
        want = selection.select_features_plain(*args, **kw)
        torch.cuda.synchronize()
        for n, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"K1 {label}: {n} differs from the plain version "
                                     f"at {int((g != w).sum())} entries")
            k1_err = max(k1_err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        log(f"K1 {label}: kernel == plain on all {len(names)} outputs "
            f"({int(got[1].sum())} corner, {int(got[3].sum())} flat picks)")
    k1_call = lambda: selection.select_features(*frame_args, **sel_kw)
    k1_ms = graph_ms(torch, k1_call, 100)
    k1_eager_ms = cuda_ms(torch, k1_call, 200)
    k1_plain_ms = cuda_ms(torch, lambda: selection.select_features_plain(*frame_args, **sel_kw), 5)
    n_rounds = feat.less_sharp_per_subregion + feat.flat_per_subregion
    k1_bytes = (S * W * (4 + 4 + 4 + 1) + 2 * si.sp.numel() * 4
                + si.sp.numel() * n_rounds * 5 + S * W)
    scanned = n_rounds * int(torch.clamp(si.ep - si.sp + 1, min=0).sum())
    k1_ops = 3 * scanned  # per scanned point: flag test, threshold, max compare
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)
    log(f"K1 times: kernel {k1_ms:.4f} ms (eager call {k1_eager_ms:.4f} ms), "
        f"plain {k1_plain_ms:.3f} ms, bound {k1_bound:.6f} ms "
        f"({k1_bytes} B, {k1_ops} ops)")

    # ---- K2 entry A: the frame's cached candidates, a numpy-made scenario
    # and the scenario with every mask off
    odo = cfg.odometry
    feats0 = features.extract_features(dev_scans[0], cfg)
    feats1 = features.extract_features(dev_scans[1], cfg)
    ostate, _ = odometry.odometry_step(odometry.init_state(cfg, dev), feats0, cfg)
    cc, sc = odometry._sweep_candidates(ostate.rel, feats1, ostate, cfg)
    frame_k2 = (feats1.sharp.xyz, cc[0], cc[1], feats1.sharp.mask,
                feats1.flat.xyz, sc[0], sc[1], sc[2], feats1.flat.mask,
                ostate.rel.quat, ostate.rel.trans)

    def scenario(seed, n_c, n_s):
        r = np.random.default_rng(seed)
        T = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
        gt_pose = Pose(se3.exp_so3(T(r.normal(0, 0.02, 3))), T(r.normal(0, 0.3, 3)))
        cx, cm = T(r.uniform(-20, 20, (n_c, 3))), T(r.uniform(size=n_c) < 0.8, torch.bool)
        sx, sm = T(r.uniform(-20, 20, (n_s, 3))), T(r.uniform(size=n_s) < 0.8, torch.bool)
        cw, sw = se3.apply(gt_pose, cx), se3.apply(gt_pose, sx)
        cand = lambda base, spread: base[:, None] + T(r.normal(0, spread, (base.shape[0], 2, 3)))
        ident = Pose.identity(dev)
        return (cx, cand(cw, 0.05), cand(cw, 0.3), cm, sx, cand(sw, 0.05),
                cand(sw, 0.2), cand(sw, 0.3), sm, ident.quat, ident.trans)

    scen = scenario(0, feat.max_sharp, feat.max_flat)
    invalid = list(scen)
    invalid[3], invalid[8] = torch.zeros_like(scen[3]), torch.zeros_like(scen[8])
    k2_kw = dict(outer_iterations=odo.outer_iterations, gn_iterations=odo.gn_iterations,
                 thr=odo.distance_sq_threshold, huber_delta=odo.huber_delta)
    k2_err = 0.0
    for label, args in (("frame", frame_k2), ("scenario", scen), ("all-invalid", invalid)):
        q, t, nc, ns = gn_odometry.associate_and_solve(*args, **k2_kw)
        qp, tp, ncp, nsp = gn_odometry.associate_and_solve_plain(*args, **k2_kw)
        torch.cuda.synchronize()
        counts = ((int(nc), int(ns)), (int(ncp), int(nsp)))
        k2_err = max(k2_err, pose_err(torch, f"K2 A {label}", (q, t), (qp, tp), counts))
    if float((t - invalid[10]).abs().max()) > 1e-5:
        raise AssertionError("K2 A all-invalid: the pose moved")
    k2_call = lambda: gn_odometry.associate_and_solve(*frame_k2, **k2_kw)
    k2_ms = graph_ms(torch, k2_call, 100)
    k2_eager_ms = cuda_ms(torch, k2_call, 200)
    k2_plain_ms = cuda_ms(torch, lambda: gn_odometry.associate_and_solve_plain(*frame_k2, **k2_kw), 5)
    Nc, Ns = frame_k2[0].shape[0], frame_k2[4].shape[0]
    _, _, nc, ns = gn_odometry.associate_and_solve(*frame_k2, **k2_kw)
    k2_bytes = Nc * (15 * 4 + 1) + Ns * (21 * 4 + 1) + 2 * 7 * 4 + 8
    k2_ops = odo.outer_iterations * (
        Nc * K2_OPS_ASSOC[0] + Ns * K2_OPS_ASSOC[1]
        + odo.gn_iterations * (int(nc) * K2_OPS_ITER[0] + int(ns) * K2_OPS_ITER[1])
    )
    k2_bound, k2_by = bound_ms(k2_bytes, k2_ops)
    log(f"K2 A times: kernel {k2_ms:.4f} ms (eager call {k2_eager_ms:.4f} ms), "
        f"plain {k2_plain_ms:.3f} ms, bound {k2_bound:.6f} ms ({k2_bytes} B, {k2_ops} ops), "
        f"cluster {gn_odometry.cluster_size(Nc, Ns, prepared=False)} blocks")

    # ---- K2 entry B: mapping's prepared factors of a frame with a dense
    # map (captured as mapping passes them in), and all-invalid factors
    captured = []
    kernel_b = gn_odometry.gn_solve_prepared

    def spy(*args, **kw):
        captured.append((args, kw))
        return gn_odometry.gn_solve_prepared_plain(*args, **kw)

    fe = FrontEnd(cfg, device="cuda")
    for i in range(PREP_FRAME + 1):
        if i == PREP_FRAME:
            gn_odometry.gn_solve_prepared = spy
        try:
            fe.step(dev_scans[i].xyz, dev_scans[i].mask)
        finally:
            gn_odometry.gn_solve_prepared = kernel_b
    prep_args, prep_kw = captured[0]
    prep_args = tuple(a.clone() for a in prep_args)
    nvc, nvs = int(prep_args[5].sum()), int(prep_args[9].sum())
    if not (nvc > 0 and nvs > 0):
        raise AssertionError(f"entry B input of frame {PREP_FRAME} has no valid factors")
    bad = list(prep_args)
    bad[5], bad[9] = torch.zeros_like(bad[5]), torch.zeros_like(bad[9])
    kb_err = 0.0
    for label, args in ((f"frame {PREP_FRAME}", prep_args), ("all-invalid", bad)):
        q, t = gn_odometry.gn_solve_prepared(*args, **prep_kw)
        qp, tp = gn_odometry.gn_solve_prepared_plain(*args, **prep_kw)
        torch.cuda.synchronize()
        nv = (int(args[5].sum()), int(args[9].sum()))
        kb_err = max(kb_err, pose_err(torch, f"K2 B {label}", (q, t), (qp, tp), (nv, nv)))
    if float((t - bad[1]).abs().max()) > 1e-5:
        raise AssertionError("K2 B all-invalid: the pose moved")
    kb_call = lambda: gn_odometry.gn_solve_prepared(*prep_args, **prep_kw)
    kb_ms = graph_ms(torch, kb_call, 100)
    kb_eager_ms = cuda_ms(torch, kb_call, 200)
    kb_plain_ms = cuda_ms(torch, lambda: gn_odometry.gn_solve_prepared_plain(*prep_args, **prep_kw), 5)
    Nc, Ns = prep_args[2].shape[0], prep_args[6].shape[0]
    kb_bytes = Nc * (9 * 4 + 1) + Ns * (7 * 4 + 1) + 2 * 7 * 4
    kb_ops = prep_kw["gn_iterations"] * (nvc * K2_OPS_ITER[0] + nvs * K2_OPS_ITER[1])
    kb_bound, kb_by = bound_ms(kb_bytes, kb_ops)
    log(f"K2 B times ({nvc}/{Nc} corner, {nvs}/{Ns} surf factors valid): kernel "
        f"{kb_ms:.4f} ms (eager call {kb_eager_ms:.4f} ms), plain {kb_plain_ms:.3f} ms, "
        f"bound {kb_bound:.6f} ms ({kb_bytes} B, {kb_ops} ops), "
        f"cluster {gn_odometry.cluster_size(Nc, Ns, prepared=True)} blocks")

    log(f"phase wall: build and kernel checks {time.perf_counter() - t_checks:.1f} s")

    # ---- main path: the full-width front end, launches counted
    t_phase = time.perf_counter()
    selection.select_features.launches = 0
    gn_odometry.associate_and_solve.launches = 0
    gn_odometry.gn_solve_prepared.launches = 0
    fe = FrontEnd(cfg, device="cuda")
    outs = []
    t_start = None
    for i, scan in enumerate(dev_scans):
        if i == WARM_FRAMES:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        outs.append(fe.step(scan.xyz, scan.mask))
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t_start) * 1e3 / (N_FRAMES - WARM_FRAMES)
    launches = {"K1": selection.select_features.launches,
                "K2 A": gn_odometry.associate_and_solve.launches,
                "K2 B": gn_odometry.gn_solve_prepared.launches}
    want = {"K1": N_FRAMES, "K2 A": N_FRAMES - 1,
            "K2 B": cfg.mapping.outer_iterations * N_FRAMES}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    mapped = torch.stack([o.mapped_pose.trans for o in outs]).cpu().numpy()
    odom = torch.stack([o.odom_world.trans for o in outs]).cpu().numpy()
    quats = torch.stack([o.mapped_pose.quat for o in outs]).cpu().numpy()
    fires = [bool(o.fire) for o in outs]
    if not (np.isfinite(mapped).all() and np.isfinite(odom).all() and np.isfinite(quats).all()):
        raise AssertionError("non-finite pose on the main path")
    rel_gt = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])[:, :3, 3]
    err = np.linalg.norm(mapped - rel_gt, axis=1)
    if err.max() > MAX_TRANS_ERR_M:
        raise AssertionError(f"mapped translation error {err.max():.3f} m > {MAX_TRANS_ERR_M} m")
    for o, f in zip(outs, fires):
        n_kf = int(o.kf_mask.sum())
        if f and not (n_kf > 0 and torch.isfinite(o.kf_xyz[o.kf_mask]).all()):
            raise AssertionError("keyframe fired with an empty or non-finite cloud")
    log(f"main path: {N_FRAMES} frames, {sum(fires)} keyframes, launches {launches}, "
        f"{ms_frame:.2f} ms/frame over frames "
        f"{WARM_FRAMES}-{N_FRAMES - 1}, max mapped-pose error {err.max():.4f} m "
        f"(mean {err.mean():.4f} m), final odom {odom[-1].round(3).tolist()}")

    log(f"phase wall: front end {time.perf_counter() - t_phase:.1f} s")

    # ---- (a) the pose graph at users' sizes
    t_phase = time.perf_counter()
    pose_graph_phase(torch, dev)
    log(f"phase wall: (a) pose graph {time.perf_counter() - t_phase:.1f} s")

    # ---- (b) the system over the 160-frame loop drive, launches counted
    t_phase = time.perf_counter()
    made = drive.get()
    scans, sys_gt = [m[0] for m in made], np.stack([m[1] for m in made])
    log(f"system drive data: {len(scans)} scans of {[len(x) for x in scans[:3]]}... points "
        f"ready {time.perf_counter() - t_phase:.1f} s after the front end")
    counters = (selection.select_features, gn_odometry.associate_and_solve,
                gn_odometry.gn_solve_prepared)
    t_drive = time.perf_counter()
    sys_cfg = config.kitti_hdl64()
    sys_cfg = sys_cfg.replace(pgo=dataclasses.replace(sys_cfg.pgo, keyframe_meter_gap=1.0))
    sys_stats = system_phase(torch, dev, sys_cfg, scans, sys_gt, counters)
    launches = dict(zip(("K1", "K2 A", "K2 B"), sys_stats["launches"]))
    want = {"K1": SYS_FRAMES, "K2 A": SYS_FRAMES - 1,
            "K2 B": config.kitti_hdl64().mapping.outer_iterations * SYS_FRAMES}
    if launches != want:
        raise AssertionError(f"system drive launches {launches}, want {want}")
    log(f"system drive: {sys_stats['frames']} frames, {sys_stats['keyframes']} keyframes, "
        f"loops {sys_stats['loops']}, launches {launches}, ATE optimised "
        f"{sys_stats['ate_opt_m']:.4f} m vs odometry {sys_stats['ate_odom_m']:.4f} m")
    log(f"system ms/frame: non-keyframe median "
        f"{sys_stats['ms_per_frame_non_keyframe_median']:.2f} (mean "
        f"{sys_stats['ms_per_frame_non_keyframe_mean']:.2f}), keyframe median "
        f"{sys_stats['ms_per_frame_keyframe_median']:.2f}, all {sys_stats['ms_per_frame_all_mean']:.2f}; "
        f"host syncs per frame: non-keyframe {sys_stats['host_syncs_per_frame_non_keyframe']:.2f}, "
        f"keyframe {sys_stats['host_syncs_per_frame_keyframe']:.2f}")
    for name, st in sys_stats["stages"].items():
        log(f"  stage {name}: {json.dumps(st)}")
    non_kf, kf_ms, fe_ms = clean_frame_times(torch, dev, sys_cfg, scans[:CLEAN_FRAMES])
    sys_stats["clean"] = {"frames": CLEAN_FRAMES, "system_non_keyframe_ms": non_kf.tolist(),
                          "system_keyframe_ms": kf_ms.tolist(), "frontend_ms": fe_ms.tolist()}
    log(f"uninstrumented, frames 2-{CLEAN_FRAMES - 1} of the drive: SlamSystem non-keyframe "
        f"median {np.median(non_kf):.2f} ms ({len(non_kf)} frames), keyframe median "
        f"{np.median(kf_ms):.2f} ms ({len(kf_ms)}); FrontEnd.step + upload median "
        f"{np.median(fe_ms):.2f} ms")
    log(f"phase wall: (b) system {time.perf_counter() - t_drive:.1f} s")

    # ---- (c) the CLI, then resumed
    t_phase = time.perf_counter()
    cli = cli_phase(os.getcwd())
    log(f"cli: {json.dumps(cli[0])}")
    log(f"cli resumed: {json.dumps(cli[1])}")
    log(f"cli --async-pipeline: {json.dumps(cli[2])}")
    log(f"phase wall: (c) CLI {time.perf_counter() - t_phase:.1f} s")

    # ---- (d1) the threaded runtime, both topologies, against (b)
    want = {"K1": ASYNC_FRAMES, "K2 A": ASYNC_FRAMES - 1,
            "K2 B": sys_cfg.mapping.outer_iterations * ASYNC_FRAMES}
    for fused in (True, False):
        t_phase = time.perf_counter()
        st, got = async_phase(torch, dev, sys_cfg, scans[:ASYNC_FRAMES], sys_stats, counters, fused)
        got = dict(zip(("K1", "K2 A", "K2 B"), got))
        if got != want:
            raise AssertionError(f"async {st['topology']} launches {got}, want {want}")
        log(f"(d1) async {st['topology']}: {json.dumps(st)}, launches {got}")
        log(f"phase wall: (d1) async {st['topology']} {time.perf_counter() - t_phase:.1f} s")

    # ---- (d2) the fused runtime at the sensor's rate over the whole drive
    t_phase = time.perf_counter()
    rt, got = realtime_phase(torch, dev, sys_cfg, scans, sys_gt, counters)
    log(f"(d2) real time: {json.dumps(rt)}, launches {dict(zip(('K1', 'K2 A', 'K2 B'), got))}")
    log(f"(d2) {rt['scans_per_sec']:.2f} scans/s, {rt['dropped_frames']} dropped, front end "
        f"{rt['frontend_ms_per_frame']:.2f} ms/frame busy, optimise {rt['optimise_calls']} calls "
        f"(first {rt['optimise_ms_first']:.1f} ms, median {rt['optimise_ms_median']:.1f} ms), "
        f"ICP {rt['icp_calls']} calls, loops {len(rt['loops'])}, ATE {rt['ate_opt_m']:.4f} m, "
        f"gate_wait {rt['stage_busy_s']['gate_wait']:.2f} s")
    log(f"phase wall: (d2) real time {time.perf_counter() - t_phase:.1f} s")

    # ---- (e) de-skew on skewed full-width frames
    t_phase = time.perf_counter()
    sk_scans, sk_gt = skewed.get()
    dk = deskew_phase(torch, dev, sk_scans, sk_gt, counters)
    log(f"(e) de-skew: {json.dumps(dk)} (launches K1, K2 A, K2 B)")
    log(f"phase wall: (e) de-skew {time.perf_counter() - t_phase:.1f} s")
    log(f"script wall: {time.perf_counter() - t_script:.1f} s")

    gn_src = "scaloam_tpu_torch/csrc/gn_odometry.cu"
    kernels = [
        {"name": "select_features", "route": "cuda",
         "source": "scaloam_tpu_torch/csrc/selection.cu",
         "replaces": "scaloam_tpu/ops/pallas/selection.py:96",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms, "eager_ms": k1_eager_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "matched": True},
        {"name": "associate_and_solve", "route": "cuda", "source": gn_src,
         "replaces": "scaloam_tpu/ops/pallas/gn_odometry.py:316",
         "launches": launches["K2 A"], "max_abs_err": k2_err, "ms": k2_ms, "eager_ms": k2_eager_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "matched": True},
        {"name": "gn_solve_prepared", "route": "cuda", "source": gn_src,
         "replaces": "scaloam_tpu/models/mapping.py:187",
         "launches": launches["K2 B"], "max_abs_err": kb_err, "ms": kb_ms, "eager_ms": kb_eager_ms,
         "plain_ms": kb_plain_ms, "bound_ms": kb_bound, "bound_by": kb_by,
         "library_ms": None, "matched": True},
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
