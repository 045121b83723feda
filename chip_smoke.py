"""Chip smoke test of the PyTorch/CUDA port (scaloam_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from scaloam_tpu_torch/csrc with
nvcc, holds each kernel entry against its plain PyTorch version on the
card at the shapes of a full-width kitti_hdl64 frame (K1 selection; K2's
odometry entry A and its prepared-factor entry B, which mapping calls),
then drives the front end (features -> odometry -> mapping -> keyframe
gate) through `FrontEnd(kitti_hdl64(), device="cuda")` over a synthetic
HDL-64 drive, counts each entry's launches on that path and checks the
poses against the drive's ground truth. The last three lines of standard
output are the kernel table (JSON), the card's name and power limit, and
the device line (JSON). Any mismatch or error raises, so the exit code is
non-zero. Without a GPU it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

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
    t0 = time.perf_counter()
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

    # ---- main path: the full-width front end, launches counted
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
