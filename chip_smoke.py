"""Chip smoke test of the PyTorch/CUDA port (scaloam_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from scaloam_tpu_torch/csrc with
nvcc, holds each kernel entry against its plain PyTorch version on the
card at the shapes of a full-width kitti_hdl64 frame (K1 selection; K2's
odometry entry A and its prepared-factor entry B, which mapping calls;
the 2-NN squared distances, squared norms and atan2 of csrc/f32ops.cu,
rounded as the reference's compiled CPU program rounds them, and
csrc/ring_azimuth.cu, a frame's ring ids and raw azimuths in one launch,
each bit-equal to its plain version; atan2 is off the path since
ring_azimuth took its calls), then drives the port's paths, each with the
kernels' launch counts set to 0 just before it and read just after:

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
  kernel launches, the launches of the keyframe backend's kernels
  (csrc/kabsch_step.cu, ICP's whole weighted-Kabsch step, csrc/hess_matvec.cu,
  the optimise's Hessian-vector product a CG step, csrc/chain_solve.cu,
  its preconditioner's block-tridiagonal solve a call, and
  csrc/segment_sum.cu, the gradient's fixed-order loop-factor sums)
  counted too, and none of csrc/kabsch.cu's rotation alone; then each of
  those kernels held against its plain version, bit for bit, on every
  input that one of the drive's loop verifications and one optimise of its
  final graph pass it (the chain solve also on the wide solve of (a)'s
  Woodbury setups), and the rotation on the H's of that verification's
  steps (and on random, near-planar, reflected, rank-2 and zero matrices);
  each timed captured beside the captured sequence it replaced, or beside
  torch.linalg.svd and index_add_;
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
  with distortion off and on; de-skewed error bounds, K2 entry A gated off;
- (f1) the multi-device layer (scaloam_tpu_torch.parallel) in a world of
  one over NCCL in this process: sharded ScanContext retrieval over
  mulran_os1_64's 8192-slot database, sharded grid k-NN over (b)'s
  mapping grids with one frame's mapping inputs, optimize_sharded on
  (a)'s 8192-node chain, each against its single-device version, with
  the all_reduce count and bytes of one optimise;
- (f2) spawned ranks on the one card over gloo with CUDA tensors (NCCL
  refuses two ranks of one communicator on a card): a 1-D world of 2 and
  the 2-D (seq 2, kf 2) world of 4, each running the same three sharded
  functions against (f1)'s single-device results and the multi-sequence
  front end over 2 full-width sequences of 8 frames of (b)'s drive
  (mapped poses against the one-sequence-at-a-time run, launch counts
  per rank), and the world of 4 the dry run at full width;
- (f3), beside (f2): SlamSystem with a backend device (cuda:1 where there
  is one, else cuda:0) over (b)'s first 32 frames, held against (b); the
  CLI with --backend-device 0, sync and --async-pipeline, and with an
  index past the cards (exit code 2);
- (g1) each other sensor preset at its full width (vlp16 at VLP-16's 1800
  columns, hdl32 and mulran_os1_64 at 2048): the kernel checks above at
  the preset's frame shapes, then `FrontEnd(<preset>(), device="cuda")`
  over 12 frames of the main path's course simulated with the preset's
  beam ladder, launches K1 12, K2 A 11, K2 B 24;
- (g2) the README's MulRan usage: `run.main(["--preset", "mulran_os1_64",
  "--mulran-dir", d, "--use-gps", "--out", o])` over a synthetic OS1-64
  course written in MulRan's layout under build/smoke_mulran (60 frames
  lapping an 8 m circle, 4 Hz GPS at an absolute altitude): exit 0, a
  loop, GPS factors in the graph, the ATE of optimized_poses.txt against
  global_pose.csv, ms/frame, the optimise's time and tier, launches;
- (g3) `mapping.map_points` on (b)'s final mapping state against a host
  flatten of the same grids (same rows, same order), and the generic
  `voxel.voxel_downsample` on a main-path keyframe cloud, with and without
  a priority centre, against the same call on the CPU; both timed;
- (h) the batched multi-sequence front end in a world of one: 8
  full-width kitti_hdl64 sequences (sequence s is frames s .. s + 3 of the
  main path's drive) through `multiseq.frame_batch`, one vmapped step a
  frame, against each sequence through the same stages alone (feature
  clouds equal, poses within 5e-4 / 5e-3 m), launches K1 1, K2 A 1 (0 on
  the first frame), K2 B 2 a batched frame, vmap's per-sample fallback
  an error; ms per batched frame at 1, 2, 4 and 8 sequences beside the
  loop's, the 8-sequence drive's peak memory; each batched kernel entry
  at 8 problems bit-equal to a launch a problem, held against its plain
  version and timed in a CUDA graph beside 8 single launches;
- (i) the outputs of the main path, (g1), (g2) and (a)'s first optimise
  held against the JAX package's runs of the same configurations on the
  same inputs (tests/data_torch_fullwidth_reference.npz, recorded on the
  CPU by tools/torch_record_reference.py): input hashes equal, then per
  drive the largest difference of each quantity within the I_*
  tolerances below. No drive runs twice;
- (j) the captured programs (scaloam_tpu_torch/compiled.py: the port's
  `jax.jit`, which every phase above runs through) against the same
  programs eager under `compiled.disabled()`, run three times eagerly for
  the spread: the main path's 12 frames through FrontEnd (the step to the
  gate and the keyframe prep), the features program and K1 with its
  inputs on the same scans; the first 32 frames of (b) through SlamSystem
  (features, odometry, mapping, gate, keyframe prep, the 256-node
  optimise); (b)'s keyframe backend: its first loop verifications
  (icp.verify_loop with the one read of its result), ScanContext's
  append and detection over its first 40 keyframe clouds from a 16-slot
  table grown twice, the graph's appends of its keyframes (one starting
  a sequence) from a 64-node graph grown once, and of its loops; (h) at 8
  sequences over 4 frames; (a)'s first optimise at each tier (its
  positions also held against the JAX recording R4 in every run).
  Outputs bit-equal to eager wherever the eager runs are bit-equal, which
  they are everywhere (the loop factors sum in one order); else integer
  and bool outputs equal and the float ones within the eager runs' spread
  of the nearest eager run; per program the ms a call, host launches,
  device operations and host reads, eager beside captured; the peak
  memory of the captured (b), (h) and 8192-node runs. (a)'s ticks replay
  captured programs, so (i) holds those against the recording too. (d1)'s
  fused run starts its pose graph at 16 nodes, so that its loop thread
  captures the larger tier, and holds its front end until that capture has
  begun and the capture until the front end has stepped two frames inside
  it; the launch counts stay exact.

Before them, the graph pools at the script's end with the keys held and
the keys of outgrown tiers dropped. The last three lines of standard
output are the kernel table (JSON, with the launches of the system drive
for K1 / K2 and the backend's five (the Kabsch rotation alone, 0 since the
step took it in; the segment sum; the matvec, the Kabsch step and the
chain solve, with their launches in (a), (d2) and (g2) and the captured
time of the sequence each replaced) and of the main path for sq_dist /
sum3_sq / atan2 (0) / ring_azimuth, and per kernel the (g1) rows and the
(g2) launches, then a row
for each batched K1 / K2 entry at (h)'s 8 problems, with (h)'s
launches), the card's name and power limit, and the device line (JSON).
Any mismatch or error raises, so the exit code is non-zero. Without a
GPU it exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

N_FRAMES = 12
MAIN_COLS = 2048  # azimuth columns of the main path's HDL-64 scans
WARM_FRAMES = 2  # excluded from the ms/frame window
PREP_FRAME = 3  # frame whose mapping factors feed entry B's check (dense map)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
ROUNDING_KERNELS = ("sq_dist", "sum3_sq", "atan2")  # csrc/f32ops.cu
# the front end's own kernels that every frame launches (K1 and K2 apart):
# the squared norms of csrc/f32ops.cu, csrc/ring_azimuth.cu once a frame and,
# from the second frame, csrc/sweep_top2.cu twice (it took the odometry's
# sq_dist blocks); csrc/f32ops.cu's atan2 is off the path
PATH_ROUNDING_KERNELS = ("sum3_sq",)
FRONT_KERNELS = ROUNDING_KERNELS + ("ring_azimuth",)
# operations of ring_azimuth a point: two atan2f, the fused multiply-add,
# root and the ring formula (~15)
RING_AZIMUTH_OPS = 2 * 34 + 15
# csrc/kabsch.cu, csrc/segment_sum.cu, csrc/hess_matvec.cu, csrc/kabsch_step.cu,
# csrc/chain_solve.cu; all but the rotation alone run on (b)'s path
BACKEND_KERNELS = ("kabsch", "segment_sum", "hess_matvec", "kabsch_step", "chain_solve")
PATH_BACKEND_KERNELS = ("segment_sum", "hess_matvec", "kabsch_step", "chain_solve")
KABSCH_TOL = 1e-6  # the kernel and its plain version perform the same IEEE operations
# float operations of one Kabsch matrix: per Jacobi rotation three dot
# products (15), the angle (13), two 3-vector pairs rotated (36); the
# scaling (18) and the rotation's assembly (~90)
KABSCH_OPS = 6 * 3 * 64 + 108
# float operations of the fused matvec (csrc/hess_matvec.cu): a node's W A v
# of its odometry factor (6 x 24), its GPS W J v (6 x 12) and its six sums
# (6 x 37); a loop row at one of its ends, its W A v (6 x 24) and J^T of it
# (6 x 12)
HMV_OPS_NODE, HMV_OPS_LOOP_END = 6 * (24 + 12 + 37), 6 * (24 + 12)
# of the Kabsch step (csrc/kabsch_step.cu): a point's pass 1 (13) and pass
# 2 (27), then a row's rotation, translation and quaternion
STEP_OPS_POINT, STEP_OPS_ROW = 40, KABSCH_OPS + 60
ATAN2_OPS = 34  # float32 operations of glibc's atan2f an element (csrc/f32ops.cu)
# of the chain solve (csrc/chain_solve.cu) a block row of a level and a
# column, down and up: six 6x6 products (6 x 11) and four 6-vector
# subtractions; the root's product
CHAIN_OPS_ROW, CHAIN_OPS_ROOT = 6 * 66 + 4 * 6, 66
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
D1_GRAPH_TIER = 16  # (d1) fused: the pose graph's first tier (nodes and loops)
D1_OVERLAP_FRAMES = 2  # (d1) fused: front-end frames stepped inside the loop thread's capture
D1_WAIT_S = 60.0  # (d1) fused: the longest either thread waits for the other
SENSOR_PERIOD_S = 0.1
# (e) de-skew: tests/test_deskew.py's scene and bounds.
DESKEW_FRAMES = 8
DESKEW_MAX_ERR_M = 0.06
DESKEW_VS_PLAIN = 0.55
# (f) the multi-device layer: mulran_os1_64's ScanContext capacity, filled
# in part; two sequences of (b)'s drive; the ranks' deadline; (f3)'s
# frames of (b) and the tolerances.
F_SC_SLOTS = 8192
F_SC_FILLED = 6000
F_SC_QUERY = 1234  # the query is this descriptor plus noise
F_SEQ_STARTS = (0, 80)
F_SEQ_FRAMES = 8
F_RANK_TIMEOUT_S = 420
F_WORLDS = (2, 4)  # a 1-D world of 2 and the 2-D (seq 2, kf 2) world of 4
F_BACKEND_FRAMES = 32
F_PGO_TOL_M = 5e-3  # the sums run in another order (tests/test_parallel.py)
F_SEQ_TOL_M = 1e-5
F_SAME_TOL_M = 1e-5  # (f3) against (b): the same kernels on the same card
# (g) the other sensor presets at full width, each with its sensor's
# columns a 10 Hz revolution; the README's MulRan usage on an OS1-64 course
# that laps an 8 m circle at 1.2 m a frame (more than the 1 m keyframe gap,
# so every frame is a keyframe, and a lap of 42 frames clears ScanContext's
# 30 excluded recent keyframes) with 4 Hz GPS at an absolute altitude; the
# generic voxel filter at a 1 m leaf over a keyframe cloud, its capacity
# half the occupied voxels so that it overflows.
G_PRESETS = (("vlp16", 1800), ("hdl32", 2048), ("mulran_os1_64", 2048))
G2_FRAMES = 60
G2_RADIUS_M = 8.0
G2_STEP_M = 1.2
G2_GPS_ALT_M = 42.0
G2_T0_NS = 1_561_000_000_000_000_000  # a MulRan-era stamp (ns)
G3_VOXEL_M = 1.0
G3_TOL_M = 1e-4  # float sums in another order on the card
# (h) the batched multi-sequence front end: sequence s is frames s .. s + 3
# of the main path's drive; the batch sizes timed; the port's odometry and
# mapped-pose tolerances (tests/test_torch_frontend.py) between the batched
# program and each sequence run alone.
H_SEQ = 8
H_FRAMES = 4
H_BATCHES = (1, 2, 4, 8)
H_Q_TOL, H_T_TOL = 5e-4, 5e-3
# (j) the captured programs against the same programs eager
# (compiled.disabled()), run several times for the eager spread: the
# main path's frames, the first J_SYS_FRAMES of (b), (h) at H_SEQ sequences
# and (a)'s first optimise at each tier; the call of each program that is
# profiled for its launches rather than timed; the CUDA runtime calls that
# count as host launches.
J_SYS_FRAMES = 32
J_PROFILE_AT = 2
J_EAGER_RUNS = 3  # eager runs a drive
# The keyframe backend's programs in (j): ICP verify on (b)'s first loop
# candidates (their recorded calls), ScanContext's append and detect over
# (b)'s first keyframe clouds, the graph's appends of (b)'s keyframes (one
# starting a sequence) and loops.
J_ICP_CALLS = 6
J_SC_KEYFRAMES = 40
J_NEW_SEQUENCE_AT = 20
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                     "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                     "cuMemcpy", "cuMemset")
# (i) the full-width runs held against the JAX package's runs of the same
# configurations on the same inputs, recorded on the CPU by
# tools/torch_record_reference.py: R1 the main path, R2 (g1)'s presets, R3
# (g2)'s MulRan CLI, R4 (a)'s first optimise. Odometry and mapped poses
# within the port's tolerances (tests/test_torch_frontend.py) on every
# frame; the gate's fire and the degenerate flag equal; feature, overflow
# and keyframe-cloud counts within max(1, 1 %); K1's picks equal, or a
# curvature near-tie within I_TIE_ULPS float32 ulps; R3's keyframes and
# GPS factors equal, its loops equal apart from a verification whose ICP
# fitness lies within 1 % of the threshold in either run, its keyframe
# positions and ATE within 5e-3 m; R4's positions within PGO_CPU_TOL_M.
REFERENCE_NPZ = os.path.join("tests", "data_torch_fullwidth_reference.npz")
I_Q_TOL, I_T_TOL = 5e-4, 5e-3
I_COUNT_REL = 0.01
I_TIE_ULPS = 4
I_FIT_REL = 0.01
I_KF_POS_TOL_M = 5e-3
I_ATE_TOL_M = 5e-3
I_PGO_TOL_M = PGO_CPU_TOL_M


def log(*a):
    print(*a, flush=True)


def graph_pool_bytes(torch):
    """The bytes the caching allocator holds in CUDA graph pools (segments
    of a pool other than the ordinary one), or None where the snapshot
    does not name a segment's pool."""
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) != (0, 0))


def phase_wall(torch, text):
    """Log a phase's wall time, `text`, with the memory the caching
    allocator holds and how much of it lies in graph pools."""
    pools = graph_pool_bytes(torch)
    pools = "not measured" if pools is None else f"{pools / 2**30:.2f} GiB"
    log(f"phase wall: {text} [{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
        f"graph pools {pools}]")


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


def _circle_frame(synthetic, i, radius, step, n_scans, n_azimuth, lidar_type):
    """Frame i of a drive around a circle (simulate_trajectory's course,
    `step` m a frame) through run.py's synthetic world, made with the
    given `synthetic` module: (points, pose)."""
    world = synthetic.make_world(seed=0, n_boxes=60, extent=70.0)
    theta = step * i / radius
    pos = np.array([radius * np.sin(theta), radius * (1 - np.cos(theta)), 1.8])
    pts = synthetic.simulate_scan(world, pos, theta, n_scans=n_scans, n_azimuth=n_azimuth,
                                  seed=i, lidar_type=lidar_type)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0], [0, 0, 1]]
    T[:3, 3] = pos
    return pts, T


def _port_synthetic():
    from scaloam_tpu_torch.utils import synthetic

    return synthetic


def _scan_job(i):
    """Frame i of run.py's synthetic drive (radius 22 m, 1 m a frame, 1024
    azimuths, HDL-64) and its ground-truth pose."""
    return _circle_frame(_port_synthetic(), i, 22.0, 1.0, 64, 1024, "HDL64")


def mulran_frame(synthetic, i):
    """Frame i of (g2)'s OS1-64 course (G2_RADIUS_M, G2_STEP_M a frame,
    2048 columns) and its ground-truth pose."""
    return _circle_frame(synthetic, i, G2_RADIUS_M, G2_STEP_M, 64, 2048, "OS1-64")


def _mulran_scan_job(i):
    return mulran_frame(_port_synthetic(), i)


def preset_drive(synthetic, sensor, cols, n_frames=N_FRAMES):
    """The main path's drive (and (g1)'s): frames at 1.2 m a frame around
    a 40 m circle in world 3, with one sensor's beam ladder (`sensor` a
    preset's SensorConfig) at `cols` columns; frame i is the same whatever
    n_frames. Returns (scans, gt poses)."""
    return synthetic.simulate_trajectory(
        synthetic.make_world(seed=3, n_boxes=60, extent=70.0), n_frames=n_frames, speed=1.2,
        radius=40.0, n_scans=sensor.n_scans, n_azimuth=cols, seed=7,
        lidar_type=sensor.lidar_type)


def _preset_drive_job(preset):
    """(g1)'s drive for one (preset, columns)."""
    from scaloam_tpu_torch import config

    name, cols = preset
    return preset_drive(_port_synthetic(), config.PRESETS[name]().sensor, cols)


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


def chain_pgo_cfg(pgo, n, n_loops):
    """(a)'s pose-graph settings for a circle chain of n nodes and n_loops
    loops, from either package's default PGOConfig `pgo`."""
    return dataclasses.replace(pgo, max_keyframes=n, max_loops=n_loops, loop_variance=1e-3,
                               cauchy_k=100.0)


# ---- (i): the recording of the JAX package's runs and the comparisons

def sha256_f32(a) -> str:
    """sha256 of an array's float32 bytes in C order."""
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float32).tobytes()).hexdigest()


def chain_sha256(odom_q, odom_t, loops) -> str:
    """sha256 of a circle chain: odometry quaternions and translations
    (float32) and loop pairs (int32)."""
    h = hashlib.sha256(np.ascontiguousarray(odom_q, dtype=np.float32).tobytes())
    h.update(np.ascontiguousarray(odom_t, dtype=np.float32).tobytes())
    h.update(np.asarray(loops, dtype=np.int32).tobytes())
    return h.hexdigest()


def load_reference(path=REFERENCE_NPZ):
    """(meta dict, {name: array}) of the recorded JAX runs. Raises when the
    file is missing: no comparison is skipped."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(str(arrays.pop("meta"))), arrays


def drive_arrays(arrays, drive):
    """The arrays of one recorded drive ("R1", "R2.vlp16", "R3", "R4.1024"),
    without the drive prefix."""
    pre = drive + "."
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def check_hashes(label, want, got):
    """Raise naming the first frame whose input differs from the recorded one."""
    want = [str(h) for h in want]
    if len(want) != len(got):
        raise AssertionError(f"(i) {label}: {len(got)} inputs, the recording has {len(want)}")
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            raise AssertionError(f"(i) {label}: the input of frame {i} differs from the "
                                 f"recorded one (sha256 {g} vs {w})")


@contextlib.contextmanager
def capture_frames():
    """While active, keeps for each frame the port extracts features from
    its ScanFeatures, K1's picks and the curvature they were made from
    (references only: nothing is computed or read during the drive).
    Yields the list of per-frame dicts."""
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import selection

    frames = []
    extract, select = features.extract_features, selection.select_features

    def spy_select(curv, *a, **k):
        out = select(curv, *a, **k)
        frames.append({"curv": curv, "picks": out[:4]})
        return out

    def spy_extract(scan, cfg):
        feats = extract(scan, cfg)
        frames[-1]["feats"] = feats
        return feats

    features.extract_features, selection.select_features = spy_extract, spy_select
    try:
        yield frames
    finally:
        features.extract_features, selection.select_features = extract, select


def frontend_record(outs, frames):
    """A front-end drive in the recording's layout (numpy), from its
    FrontendOutputs and capture_frames()'s frames, plus the curvature
    ("curv" [F, S, W]) for the near-tie check."""
    import torch

    def stack(f, items=outs):
        return torch.stack([f(o) for o in items]).cpu().numpy()

    feats = [f["feats"] for f in frames]
    counts = stack(lambda f: torch.stack(
        [c.mask.sum() for c in (f.sharp, f.less_sharp, f.flat, f.less_flat)]), feats)
    picks = [[p.cpu().numpy() for p in f["picks"]] for f in frames]
    return {
        "odom_q": stack(lambda o: o.odom_world.quat), "odom_t": stack(lambda o: o.odom_world.trans),
        "map_q": stack(lambda o: o.mapped_pose.quat), "map_t": stack(lambda o: o.mapped_pose.trans),
        "fire": stack(lambda o: o.fire), "degenerate": stack(lambda o: o.degenerate),
        "kf_count": stack(lambda o: o.kf_mask.sum()).astype(np.int32),
        "feat_counts": counts.astype(np.int32),
        "overflow": stack(lambda f: f.overflow, feats).astype(np.int32),
        "corner_idx": np.stack([p[0] for p in picks]).astype(np.int16),
        "corner_ok": np.stack([p[1] for p in picks]).astype(bool),
        "flat_idx": np.stack([p[2] for p in picks]).astype(np.int16),
        "flat_ok": np.stack([p[3] for p in picks]).astype(bool),
        "curv": torch.stack([f["curv"] for f in frames]).cpu().numpy(),
    }


def _quat_dist(q, qw):
    """Per-row max |q - qw| with the quaternions' signs aligned."""
    sign = np.where(np.sum(q * qw, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return np.abs(q * sign - qw).max(axis=-1)


def _count_off(got, want):
    """Count departures past max(1, I_COUNT_REL of the recorded count)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    return np.abs(got - want) > np.maximum(1, I_COUNT_REL * want)


def compare_frontend(label, want, got):
    """Hold a front-end drive (frontend_record's layout) against its
    recording. Returns the largest difference of each quantity; raises past
    the (i) tolerances, naming the frames."""
    n = len(want["fire"])
    if len(got["fire"]) != n:
        raise AssertionError(f"(i) {label}: {len(got['fire'])} frames, recorded {n}")
    row = {}
    faults = []
    for pose in ("odom", "map"):
        dq = _quat_dist(got[pose + "_q"], want[pose + "_q"])
        dt = np.abs(got[pose + "_t"] - want[pose + "_t"]).max(axis=-1)
        row[pose + "_dq"], row[pose + "_dt_m"] = float(dq.max()), float(dt.max())
        bad = np.nonzero((dq > I_Q_TOL) | (dt > I_T_TOL))[0]
        if len(bad):
            faults.append(f"{pose} pose past {I_Q_TOL} / {I_T_TOL} m at frames {bad.tolist()}")
    for flag in ("fire", "degenerate"):
        bad = np.nonzero(got[flag] != want[flag])[0]
        row[flag + "_differ"] = len(bad)
        if len(bad):
            faults.append(f"{flag} differs at frames {bad.tolist()}")
    for key in ("feat_counts", "overflow", "kf_count"):
        diff = np.abs(got[key].astype(np.int64) - want[key].astype(np.int64))
        row[key + "_max_diff"] = int(diff.max())
        bad = np.nonzero(_count_off(got[key], want[key]).reshape(n, -1).any(axis=1))[0]
        if len(bad):
            faults.append(f"{key} past max(1, {I_COUNT_REL:.0%}) at frames {bad.tolist()}")
    n_diff, worst = 0, 0.0
    for kind in ("corner", "flat"):
        wi, wo = want[kind + "_idx"].astype(np.int64), want[kind + "_ok"]
        gi, go = got[kind + "_idx"].astype(np.int64), got[kind + "_ok"]
        ok_diff = int((wo != go).sum())
        if ok_diff:
            faults.append(f"K1 {kind} picks: {ok_diff} ok flags differ")
        d = wo & go & (wi != gi)
        n_diff += ok_diff + int(d.sum())
        if d.any():
            f, r = np.nonzero(d)[:2]
            cw = got["curv"][f, r, wi[d]].astype(np.float32)
            cg = got["curv"][f, r, gi[d]].astype(np.float32)
            ulps = np.abs(cw - cg) / np.spacing(np.maximum(np.abs(cw), np.abs(cg)))
            worst = max(worst, float(ulps.max()))
    row["k1_picks_differ"], row["k1_curv_gap_ulps"] = n_diff, worst
    if worst > I_TIE_ULPS:
        faults.append(f"K1: a differing pick is no curvature near-tie ({worst:.1f} ulps > "
                      f"{I_TIE_ULPS})")
    log(f"(i) {label}: {json.dumps(row)}")
    if faults:
        raise AssertionError(f"(i) {label}: " + "; ".join(faults))
    return row


def compare_mulran(want, got, threshold):
    """Hold (g2)'s MulRan CLI run against R3. got: keyframes [K] frame
    indices, verify [V, 2] pairs with verify_fitness [V] and
    verify_accepted [V], loops [L, 2], gps_factors, optimized_poses
    [K, 3, 4], ate_m. Returns the largest differences; raises past the (i)
    tolerances."""
    faults = []
    row = {"keyframes_equal": bool(np.array_equal(got["keyframes"], want["keyframes"])),
           "gps_factors": [int(got["gps_factors"]), int(want["gps_factors"])]}
    if not row["keyframes_equal"]:
        faults.append(f"keyframes differ: {got['keyframes'].tolist()} vs "
                      f"{want['keyframes'].tolist()}")
    if row["gps_factors"][0] != row["gps_factors"][1]:
        faults.append(f"GPS factors {row['gps_factors']}")

    def near_threshold(run, pair):
        hit = np.all(run["verify"] == pair, axis=1)
        fit = run["verify_fitness"][hit]
        return bool(np.any(np.abs(fit - threshold) <= I_FIT_REL * threshold))

    got_loops = {tuple(int(v) for v in p) for p in got["loops"]}
    want_loops = {tuple(int(v) for v in p) for p in want["loops"]}
    row["loops"] = [len(got_loops), len(want_loops)]
    row["loops_differ"] = sorted(got_loops ^ want_loops)
    for pair in row["loops_differ"]:
        if near_threshold(got, pair) or near_threshold(want, pair):
            log(f"(i) R3: loop {pair} differs, its ICP fitness within {I_FIT_REL:.0%} of "
                f"{threshold} in one run")
        else:
            faults.append(f"loop {pair} in one run only")
    if row["keyframes_equal"]:
        d = np.abs(got["optimized_poses"][:, :, 3] - want["optimized_poses"][:, :, 3]).max()
        row["kf_pos_max_diff_m"] = float(d)
        if not d <= I_KF_POS_TOL_M:
            faults.append(f"optimised keyframe positions {d:.3e} m > {I_KF_POS_TOL_M}")
    row["ate_m"] = [float(got["ate_m"]), float(want["ate_m"])]
    if not abs(row["ate_m"][0] - row["ate_m"][1]) <= I_ATE_TOL_M:
        faults.append(f"ATE {row['ate_m']} m")
    log(f"(i) R3: {json.dumps(row)}")
    if faults:
        raise AssertionError("(i) R3: " + "; ".join(faults))
    return row


def compare_pose_graph(n, want_trans, got_trans):
    """R4: one optimise's positions against the recording."""
    d = float(np.abs(np.asarray(got_trans) - want_trans).max())
    log(f"(i) R4 {n} nodes: max |dt| {d:.3e} m (tol {I_PGO_TOL_M})")
    if not d <= I_PGO_TOL_M:
        raise AssertionError(f"(i) R4 {n} nodes: positions {d:.3e} m from the recording")
    return d


def launch_profile(torch, fn):
    """(fn(), device operations it ran, host launches it made), under
    torch.profiler: the device's kernels and copies, and the host's calls of
    the CUDA runtime or driver that launch a kernel, a graph, a copy or a
    fill (HOST_LAUNCH_CALLS)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        out = fn()
        torch.cuda.synchronize()
    events = p.events()
    device = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    host = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith(HOST_LAUNCH_CALLS))
    return out, device, host


def _backend_counters():
    """The keyframe backend's kernel wrappers, by BACKEND_KERNELS name."""
    from scaloam_tpu_torch.ops.kernels import chain_solve, hess_matvec, kabsch, segment_sum

    return {"kabsch": kabsch.kabsch_rotation, "segment_sum": segment_sum.add,
            "hess_matvec": hess_matvec.hess_matvec, "kabsch_step": kabsch.kabsch_step,
            "chain_solve": chain_solve.chain_solve}


def _front_counters():
    """The front end's kernel wrappers besides K1 and K2, by FRONT_KERNELS
    name, and the odometry's sweep."""
    from scaloam_tpu_torch.ops.kernels import f32ops, ring_azimuth, sweep_top2

    return {**{name: getattr(f32ops, name) for name in ROUNDING_KERNELS},
            "ring_azimuth": ring_azimuth.ring_azimuth, "sweep_top2": sweep_top2.sweep_top2}


def _launch_counts():
    """The kernels' launch counters, by kernel."""
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection

    return {"K1": selection.select_features.launches,
            "K2 A": gn_odometry.associate_and_solve.launches,
            "K2 B": gn_odometry.gn_solve_prepared.launches,
            **{name: fn.launches for name, fn in _front_counters().items()},
            **{name: fn.launches for name, fn in _backend_counters().items()}}


def _zero_launches():
    """Set every kernel's launch counter to 0."""
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection

    for fn in (selection.select_features, gn_odometry.associate_and_solve,
               gn_odometry.gn_solve_prepared, *_front_counters().values(),
               *_backend_counters().values()):
        fn.launches = 0


def _check_launches(label, got, want, at_least=PATH_ROUNDING_KERNELS):
    """K1 / K2, ring_azimuth and atan2 launched exactly as `want` says; the
    rounding kernels named in `at_least` (their counts follow the clouds'
    tiling) at least once."""
    k = {key: got[key] for key in want}
    if k != want or min(got[key] for key in at_least) < 1:
        raise AssertionError(f"{label}launches {got}, want {want} and every one of "
                             f"{at_least} at least once")


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
    profiled for its device operations and host launches (launch_profile)
    instead and left out of the times;
    a stage without one (a call that changes no state) is profiled by
    `replay` on its last call's arguments."""

    def __init__(self, torch, name, fn, syncs: SyncCounter, profile_at=None):
        self.torch, self.name, self.fn, self.syncs = torch, name, fn, syncs
        self.profile_at = profile_at
        self.ms, self.sync_counts, self.launches, self.last = [], [], None, None
        self.host_launches = None
        self.profiled_calls = 0  # calls of the drive that were profiled, not timed

    def __call__(self, *a, **k):
        torch = self.torch
        torch.cuda.synchronize()
        if self.launches is None and len(self.ms) == self.profile_at:
            out, self.launches, self.host_launches = launch_profile(
                torch, lambda: self.fn(*a, **k))
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
            _, self.launches, self.host_launches = launch_profile(
                self.torch, lambda: self.fn(*a, **k))

    def summary(self) -> dict:
        ms = np.asarray(self.ms)
        return {"calls": len(self.ms) + self.profiled_calls,
                "ms_mean": float(ms.mean()) if len(ms) else None,
                "ms_median": float(np.median(ms)) if len(ms) else None,
                "ms_max": float(ms.max()) if len(ms) else None,
                "host_syncs_mean": float(np.mean(self.sync_counts)) if self.sync_counts else None,
                "launches": self.launches, "host_launches": self.host_launches}


def pose_graph_phase(torch, dev, tiers=PGO_TIERS):
    """(a): optimise ticks on the circle chains; returns a row per tier,
    each with the positions after the first optimise ("first_trans") and
    the chain's hash for phase (i). A tier's first call (eager, then
    captured) is made before the ticks and its result dropped, so every
    tick, the first one that (i) holds against the recording included,
    replays the captured program."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.types import Pose

    rows = []
    for n, nl in tiers:
        gt, oq, ot, loops = circle_chain(n, nl, seed=n)
        cfg = chain_pgo_cfg(config.PGOConfig(), n, nl)
        g = build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev)
        drift = ate_m(ot, gt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg.optimize(g, cfg)  # the key's first call: eager, then captured; result dropped
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        ticks = []  # replays from here on
        backend = _backend_counters()
        for c in backend.values():
            c.launches = 0
        for tick in range(PGO_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = pg.optimize(g, cfg)
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)
            if tick == 0:
                first_trans = g.poses.trans.cpu().numpy()
            if tick == 0 and n == PGO_CPU_TIER:
                g_cpu = pg.optimize(build_graph(torch, pg, Pose, cfg, oq, ot, loops, "cpu"), cfg)
                diff = float((g.poses.trans.cpu() - g_cpu.poses.trans).abs().max())
                if not diff <= PGO_CPU_TOL_M:
                    raise AssertionError(f"pose graph {n}: card vs CPU {diff:.2e} m")
                log(f"pose graph {n}: card vs CPU after one optimise: max |dt| {diff:.2e} m "
                    f"(tol {PGO_CPU_TOL_M})")
        kernel_launches = {name: c.launches // PGO_TICKS for name, c in backend.items()}
        trans = g.poses.trans.cpu().numpy()
        if not (np.isfinite(trans).all() and np.isfinite(g.poses.quat.cpu().numpy()).all()):
            raise AssertionError(f"pose graph {n}: non-finite poses")
        opt = ate_m(trans, gt)
        if not opt <= 0.5 * drift:
            raise AssertionError(f"pose graph {n}: ATE {opt:.3f} m > half the drift {drift:.3f} m")
        _, launches, host_launches = launch_profile(torch, lambda: pg.optimize(g, cfg))
        with SyncCounter(torch) as sc:
            pg.optimize(g, cfg)
            syncs = sc.count()
        row = {"nodes": n, "loops": nl, "woodbury": pg.uses_woodbury(n, nl, cfg),
               "ms_per_optimise": ticks, "ms_first_call": capture_ms,
               "launches_per_optimise": launches,
               "host_launches_per_optimise": host_launches,
               "host_syncs_per_optimise": syncs, "kernel_launches_per_optimise": kernel_launches,
               "ate_drift_m": drift, "ate_opt_m": opt,
               "first_trans": first_trans, "chain_sha256": chain_sha256(oq, ot, loops)}
        log(f"pose graph {n} nodes / {nl} loops ({'Woodbury' if row['woodbury'] else 'chain-CG'}): "
            f"ms per optimise {[round(x, 2) for x in ticks]} (replays; the key's first call, eager "
            f"then captured, {capture_ms:.1f} ms), {launches} "
            f"device operations and {host_launches} host launches a call, {syncs} host syncs, "
            f"backend kernel launches a call {kernel_launches}, ATE {drift:.4f} -> {opt:.4f} m")
        rows.append(row)
    return rows


def system_phase(torch, dev, cfg, scans, gt, launch_counters):
    """(b): the drive through SlamSystem(cfg); returns the stats, with the
    first J_ICP_CALLS calls of icp.verify_loop (their arguments) for (j)
    and the backend kernel checks."""
    from scaloam_tpu_torch.models import pipeline, posegraph
    from scaloam_tpu_torch.ops import icp
    from scaloam_tpu_torch.utils.evaluation import ate_rmse

    icp_calls, verify = [], icp.verify_loop

    def recorded(*a, **k):  # the inputs are fresh uploads a call: kept as they are
        if len(icp_calls) < J_ICP_CALLS:
            icp_calls.append((a, k))
        return verify(*a, **k)

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
    icp.verify_loop = recorded
    s.sc.make_and_save = stages["sc make"]
    s.sc.detect_loop_closure_id = stages["sc detect"]
    s._icp_verify = stages["icp verify"]
    frame_ms, frame_syncs, kf_flags, odom_first, mapped_first = [], [], [], [], []
    snapshot = None
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
                if i < F_BACKEND_FRAMES:
                    mapped_first.append(torch.cat([r.mapped_pose.quat, r.mapped_pose.trans]))
                if i == F_BACKEND_FRAMES - 1:  # for (f3), outside the frame's time
                    snapshot = (s.optimized_poses(), list(s.loops_found))
        torch.cuda.synchronize()
    finally:
        pipeline._prepare_keyframe, posegraph.add_keyframe, posegraph.optimize = orig
        icp.verify_loop = verify
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
        "icp_ms": stages["icp verify"].ms, "icp_calls": icp_calls,
        "odom_first": torch.stack(odom_first).cpu().numpy(),
        "keyframes_first": int(np.sum(kf[:ASYNC_FRAMES])),
        "first_frames": {"mapped": torch.stack(mapped_first).cpu().numpy(),
                         "keyframe": kf[:F_BACKEND_FRAMES].tolist(),
                         "optimized": snapshot[0], "loops": snapshot[1]},
        "system": s,
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


@contextlib.contextmanager
def capture_overlap(pipe):
    """(d1) fused: the loop thread's first capture runs while the front end
    steps. Once the pose graph has outgrown its first tier, the front end
    waits before its next frame until that capture has begun; the capture,
    once begun, waits until the front end has stepped D1_OVERLAP_FRAMES
    frames begun after it. Yields {"frames_in_capture": N, "thread": the
    capturing thread's name}."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models import frontend
    from scaloam_tpu_torch.models import posegraph as pg

    seen = {"frames_in_capture": 0, "thread": None}
    begun, stepped = threading.Event(), threading.Event()
    step, capture = frontend.frontend_step, compiled._capture

    def spy_step(*a, **k):
        if (threading.current_thread().name == "fused_frontend_worker" and not stepped.is_set()
                and pg.node_capacity(pipe.sys.graph) > D1_GRAPH_TIER):
            begun.wait(D1_WAIT_S)
        inside = begun.is_set() and not stepped.is_set()
        out = step(*a, **k)
        if inside:
            seen["frames_in_capture"] += 1
            if seen["frames_in_capture"] >= D1_OVERLAP_FRAMES:
                stepped.set()
        return out

    def spy_capture(pool, run):
        if threading.current_thread().name != "loop_worker" or begun.is_set():
            return capture(pool, run)

        def held():
            seen["thread"] = threading.current_thread().name
            begun.set()
            stepped.wait(D1_WAIT_S)
            return run()
        return capture(pool, held)

    frontend.frontend_step, compiled._capture = spy_step, spy_capture
    try:
        yield seen
    finally:
        frontend.frontend_step, compiled._capture = step, capture


def async_phase(torch, dev, cfg, scans, sync_stats, counters, fused):
    """(d1): AsyncSlamPipeline over scans fed at once, held against the
    sync drive's odometry and keyframe count on the same frames; returns
    (stats, launches). The fused run's pose graph starts at the
    D1_GRAPH_TIER-node tier, so the loop thread captures the larger tier
    it grows into; capture_overlap makes the front end step frames inside
    that capture (compiled.py's thread-local capture), and the launches
    counted stay exact."""
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.models.pipeline import SlamSystem
    from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline

    topo = cfg.replace(runtime=dataclasses.replace(cfg.runtime, fused_frontend=fused))
    system = None
    if fused:
        system = SlamSystem(topo, device=dev)
        system.graph = pg.init_graph(topo.pgo, dev, initial_nodes=D1_GRAPH_TIER,
                                     initial_loops=D1_GRAPH_TIER)
    pipe = AsyncSlamPipeline(topo, drop_backlog=False, system=system, device=dev)
    if pipe.fused != fused:
        raise AssertionError(f"async topology: fused {pipe.fused}, want {fused}")
    pipe.start()
    captures = pg.optimize.captures
    for counter in counters:
        counter.launches = 0
    with capture_overlap(pipe) if fused else contextlib.nullcontext() as overlap:
        t0 = time.perf_counter()
        for i, pts in enumerate(scans):
            pipe.feed(SENSOR_PERIOD_S * i, pts)
        pipe.finish()
        wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    n = len(scans)
    tiers = pg.node_capacity(pipe.sys.graph)
    odom = np.stack([x for _, x in pipe.odom_results]) if pipe.odom_results else np.zeros((0, 3))
    err = float(np.abs(odom - sync_stats["odom_first"][:n]).max()) if len(odom) == n else None
    stats = {"topology": "fused" if fused else "separate", "frames": n, "wall_s": wall,
             "dropped_frames": pipe.dropped_frames, "odom_results": len(pipe.odom_results),
             "mapped_results": len(pipe.mapped_results), "keyframes": len(pipe.sys.keyframes),
             "sync_keyframes": sync_stats["keyframes_first"], "max_odom_err_m": err,
             "workers_alive": pipe.workers_alive, "graph_nodes_capacity": tiers,
             "optimise_tiers_captured_by_the_loop_thread": pg.optimize.captures - captures,
             "capture_overlap": overlap}
    if not (pipe.dropped_frames == 0 and len(pipe.odom_results) == n
            and len(pipe.mapped_results) == n and pipe.workers_alive == 0
            and len(pipe.sys.keyframes) == sync_stats["keyframes_first"]
            and err is not None and err <= ASYNC_ODOM_TOL_M
            and (not fused or (stats["optimise_tiers_captured_by_the_loop_thread"] >= 1
                               and overlap["thread"] == "loop_worker"
                               and overlap["frames_in_capture"] >= D1_OVERLAP_FRAMES))):
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


def _sc_case(torch, dev):
    """(f) ScanContext retrieval at mulran_os1_64's settings: F_SC_FILLED
    random descriptors in F_SC_SLOTS slots and, as the query, one of them
    turned by 7 sectors plus noise. Returns (descriptors, ring keys, count,
    query)."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.ops import scancontext as sc_ops

    cfg = config.mulran_os1_64().scancontext
    rng = np.random.default_rng(11)
    desc = np.zeros((F_SC_SLOTS, cfg.num_ring, cfg.num_sector), np.float32)
    desc[:F_SC_FILLED] = rng.uniform(0, 5, size=(F_SC_FILLED, cfg.num_ring, cfg.num_sector))
    query = np.roll(desc[F_SC_QUERY], 7, axis=1) + rng.normal(0, 0.05, desc.shape[1:])
    d = torch.from_numpy(desc).to(dev)
    return (d, sc_ops.ring_key(d), torch.tensor(F_SC_FILLED, device=dev),
            torch.from_numpy(query.astype(np.float32)).to(dev))


def _grid_queries(torch, system):
    """(f) The mapping grids as (b)'s drive leaves them and, as queries,
    one frame's mapping inputs: the last frame's republished corner / surf
    clouds, voxel filtered as mapping_step filters them, at the last
    mapped pose. Returns {name: (grid, query, query mask)}."""
    from scaloam_tpu_torch.ops import se3, voxel

    m = system.cfg.mapping
    out = {}
    for name, cloud, res, cap, grid in (
            ("corner", system.o_state.last_corner, m.line_resolution, m.max_corner_input,
             system.m_state.corner_grid),
            ("surf", system.o_state.last_surf, m.plane_resolution, m.max_surf_input,
             system.m_state.surf_grid)):
        xyz, mask, _ = voxel.voxel_downsample_packed(cloud.xyz, cloud.mask, res, cap,
                                                     xy_bits=10, z_bits=9)
        out[name] = (grid, se3.apply(system.m_state.pose, xyz), mask)
    return out


def _knn_args(cfg):
    """mapping_step's candidate gather (models/mapping.py)."""
    m = cfg.mapping
    return dict(gx=m.grid_xy, gy=m.grid_xy, gz=m.grid_z, cell_size=m.cell_size, reach=1.0,
                k=max(8, m.knn))


def _pgo_cfg():
    """(f) Phase (a)'s largest tier at the large tier's iterations (1 GN x
    24 CG), which optimize applies there: (cfg, cg_iters)."""
    from scaloam_tpu_torch import config

    n, nl = PGO_TIERS[-1]
    base = config.PGOConfig()
    cfg = dataclasses.replace(base, max_keyframes=n, max_loops=nl, loop_variance=1e-3,
                              cauchy_k=100.0,
                              gn_iterations=min(base.gn_iterations, base.gn_iterations_large))
    return cfg, min(64, cfg.cg_iters_large)


def _one_sequence(torch, dev, cfg, xyz, mask):
    """One sequence through multiseq's stage wiring, frame by frame:
    mapped poses [frames, 7] (quaternion, translation)."""
    from scaloam_tpu_torch.models import mapping, odometry
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.types import LidarScan

    o, m = odometry.init_state(cfg, dev), mapping.init_state(cfg, dev)
    out = []
    for f in range(xyz.shape[0]):
        feats = features.extract_features(LidarScan(xyz[f], mask[f]), cfg)
        o, o_out = odometry.odometry_step(o, feats, cfg)
        m, m_out = mapping.mapping_step(m, o_out.world, feats.less_sharp, feats.less_flat, cfg)
        out.append(torch.cat([m_out.pose.quat, m_out.pose.trans]))
    return torch.stack(out)


def _sharded_calls(torch, mesh, inp):
    """The three sharded functions over the kf axis of `mesh`, each on this
    rank's shard of the inputs: (results, ms a call)."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.parallel import gridmap as pgrid, mesh as mesh_mod, pgo
    from scaloam_tpu_torch.parallel import sc_retrieval

    desc, keys, count, query = inp["sc"]
    sc_cfg = config.mulran_os1_64().scancontext
    d_local, k_local = mesh_mod.shard_rows(mesh, desc), mesh_mod.shard_rows(mesh, keys)
    sc = lambda: sc_retrieval.detect_loop_sharded(mesh, query, d_local, k_local, count, sc_cfg)
    res = {"sc": torch.stack([x.to(torch.float64) for x in sc()])}
    ms = {"sc": cuda_ms(torch, sc, 10, warmup=1)}
    knn_args = _knn_args(config.kitti_hdl64())
    for name in ("corner", "surf"):
        grid, q, qm = inp[name]
        slab = pgrid.shard_grid(mesh, grid)
        knn = lambda: pgrid.knn_grid_sharded(mesh, slab, q, qm, **knn_args)
        res[name] = knn()
        ms[name] = cuda_ms(torch, knn, 5, warmup=1)
    pgo_cfg, cg_iters = _pgo_cfg()
    graph = inp["pgo"]
    opt = lambda: pgo.optimize_sharded(graph, pgo_cfg, mesh, cg_iters=cg_iters)
    g = opt()
    res["pgo"] = torch.cat([g.poses.quat, g.poses.trans], dim=-1)
    ms["pgo"] = cuda_ms(torch, opt, 2, warmup=1)
    return res, ms


def _check_sharded(label, torch, got, want) -> dict:
    """Sharded against single-device: the retrieval's index and yaw equal
    and its distance within 1e-6; the k-NN distances equal and the
    neighbours equal within reach; the optimised translations within
    F_PGO_TOL_M. Returns the largest differences."""
    diff = {"sc_dist": float((got["sc"][2] - want["sc"][2]).abs())}
    if not (torch.equal(got["sc"][:2], want["sc"][:2]) and diff["sc_dist"] <= 1e-6
            and int(want["sc"][0]) == F_SC_QUERY):
        raise AssertionError(f"{label} retrieval {got['sc'].tolist()} vs {want['sc'].tolist()}")
    for name in ("corner", "surf"):
        (d, nn), (wd, wnn) = got[name], want[name]
        near = wd < 1.0
        if not (torch.equal(d, wd) and torch.equal(nn[near], wnn[near])):
            raise AssertionError(f"{label} {name} k-NN differs at "
                                 f"{int((d != wd).sum())} distances")
        diff[f"{name}_within_reach"] = int(near.sum())
    diff["pgo_m"] = float((got["pgo"][:, 4:] - want["pgo"][:, 4:]).abs().max())
    if not diff["pgo_m"] <= F_PGO_TOL_M:
        raise AssertionError(f"{label} optimize_sharded vs optimize: {diff['pgo_m']:.2e} m")
    return diff


def _f2_rank(device, world, rank, store, inputs_path, out_path):
    """(f2): one rank of a world on the one card, gloo with CUDA tensors:
    the sharded functions over its kf axis, then the multi-sequence front
    end over its sequence axis (and, in the 2-D world, the dry run at full
    width); writes its results to out_path."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection
    from scaloam_tpu_torch.parallel import distributed, dryrun, mesh as mesh_mod, multiseq

    distributed.initialize(f"file://{store}", world, rank, backend="gloo",
                           timeout=F_RANK_TIMEOUT_S)
    inp = torch.load(inputs_path, map_location=dev, weights_only=False)  # this script's file
    mesh = (mesh_mod.make_mesh(world, dev.type) if world < 4
            else mesh_mod.make_mesh2d(2, world // 2, dev.type))
    out, ms = _sharded_calls(torch, mesh, inp)
    out.update(ms=ms, layout={a: mesh_mod.axis_size(mesh, a) for a in mesh.mesh_dim_names})

    cfg = config.kitti_hdl64()
    xyz, mask = inp["seq_xyz"], inp["seq_mask"]  # [n_seq, frames, P, 3] / [n_seq, frames, P]
    o_states, m_states = multiseq.shard_states(multiseq.init_states(xyz.shape[0], cfg, dev), mesh)
    counters = (selection.select_features, gn_odometry.associate_and_solve,
                gn_odometry.gn_solve_prepared)
    for c in counters:
        c.launches = 0
    mapped = []
    t0 = time.perf_counter()
    for f in range(xyz.shape[1]):
        o_states, m_states, _, m_pose = multiseq.frame_batch(
            o_states, m_states, xyz[:, f], mask[:, f], cfg, mesh=mesh)
        p = multiseq.gather_poses(m_pose, mesh)
        mapped.append(torch.cat([p.quat, p.trans], dim=-1))
    torch.cuda.synchronize()
    out.update(launches=[c.launches for c in counters], local_sequences=multiseq.num_sequences(o_states),
               multiseq_s=time.perf_counter() - t0, mapped=torch.stack(mapped, dim=1))
    if world >= 4:
        res = dryrun.dryrun(dev, cfg=cfg)
        out["dryrun"] = {"layout": res["layout"], "mapped": res["mapped"].trans}
    torch.save(out, out_path)


def multidevice_phase(torch, dev, root, sys_stats, scans):
    """(f1), then (f2)'s start: a world of one over NCCL in this process,
    each sharded function against its single-device version on the card;
    (f2)'s inputs written and its ranks started. Returns (single-device
    results, (f1)'s stats, a function that waits for (f2)'s ranks)."""
    import shutil

    import torch.distributed as tdist

    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.ops import gridmap
    from scaloam_tpu_torch.ops import scancontext as sc_ops
    from scaloam_tpu_torch.parallel import distributed, pgo
    from scaloam_tpu_torch.types import LidarScan, Pose

    work = os.path.join(root, "build", "smoke_multidevice")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    distributed.initialize(f"file://{work}/f1_store", 1, 0, timeout=120)  # NCCL on a card
    mesh = distributed.global_mesh(dev.type)
    log(f"(f1) world of 1: backend {tdist.get_backend()}, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.mesh.shape)}, initialised in {time.perf_counter() - t0:.1f} s")

    cfg = config.kitti_hdl64()
    pgo_cfg, cg_iters = _pgo_cfg()
    _, oq, ot, loops = circle_chain(pgo_cfg.max_keyframes, pgo_cfg.max_loops,
                                    seed=pgo_cfg.max_keyframes)
    graph = build_graph(torch, pg, Pose, pgo_cfg, oq, ot, loops, dev)
    inp = {"sc": _sc_case(torch, dev), **_grid_queries(torch, sys_stats["system"]),
           "pgo": graph}
    single, ms = {}, {}
    desc, keys, count, query = inp["sc"]
    sc_cfg = config.mulran_os1_64().scancontext
    sc1 = lambda: sc_ops.detect_loop(query, sc_ops.ring_key(query), desc, keys, count, sc_cfg)
    single["sc"] = torch.stack([x.to(torch.float64) for x in sc1()])
    ms["sc"] = cuda_ms(torch, sc1, 10, warmup=1)
    for name in ("corner", "surf"):
        grid, q, qm = inp[name]
        knn1 = lambda: gridmap.knn_grid(grid, q, qm, **_knn_args(cfg))
        single[name] = knn1()
        ms[name] = cuda_ms(torch, knn1, 5, warmup=1)
    opt1 = lambda: pg.optimize(graph, pgo_cfg, cg_iters=cg_iters)  # chain-CG at this tier
    g = opt1()
    single["pgo"] = torch.cat([g.poses.quat, g.poses.trans], dim=-1)
    ms["pgo"] = cuda_ms(torch, opt1, 2, warmup=1)

    sizes = []
    orig = tdist.all_reduce

    def counted(t, *a, **k):
        sizes.append(t.numel() * t.element_size())
        return orig(t, *a, **k)

    tdist.all_reduce = counted
    try:
        pgo.optimize_sharded(graph, pgo_cfg, mesh, cg_iters=cg_iters)
    finally:
        tdist.all_reduce = orig
    got, ms_sharded = _sharded_calls(torch, mesh, inp)
    diff = _check_sharded("(f1) world of 1", torch, got, single)
    tdist.destroy_process_group()
    stats = {"single_ms": ms, "sharded_ms": ms_sharded, "max_diff": diff,
             "pgo_all_reduces": len(sizes), "pgo_all_reduce_bytes": int(sum(sizes)),
             "sc_single": single["sc"].tolist()}
    log(f"(f1) ms a call, single-device / sharded: " + ", ".join(
        f"{k} {ms[k]:.3f} / {ms_sharded[k]:.3f}" for k in ms) + f"; differences {diff}")
    log(f"(f1) one optimize_sharded ({pgo_cfg.max_keyframes} nodes, {pgo_cfg.max_loops} loops, "
        f"{pgo_cfg.gn_iterations} GN x {cg_iters} CG): {len(sizes)} all_reduces, "
        f"{sum(sizes)} bytes")

    # (f2)'s inputs, and the one-sequence-at-a-time run it is held against
    seqs = [[LidarScan.from_numpy(scans[s0 + f], cfg.sensor.max_points, dev)
             for f in range(F_SEQ_FRAMES)] for s0 in F_SEQ_STARTS]
    seq_xyz = torch.stack([torch.stack([sc.xyz for sc in seq]) for seq in seqs])
    seq_mask = torch.stack([torch.stack([sc.mask for sc in seq]) for seq in seqs])
    single["mapped"] = torch.stack([_one_sequence(torch, dev, cfg, seq_xyz[i], seq_mask[i])
                                    for i in range(len(seqs))])
    inputs_path = os.path.join(work, "f2_inputs.pt")
    torch.save({k: inp[k] for k in ("sc", "corner", "surf", "pgo")}
               | {"seq_xyz": seq_xyz, "seq_mask": seq_mask}, inputs_path)
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world in F_WORLDS:
        for rank in range(world):
            p = ctx.Process(target=_f2_rank, daemon=True, args=(
                str(dev), world, rank, os.path.join(work, f"f2_store_{world}"), inputs_path,
                os.path.join(work, f"f2_out_{world}_{rank}.pt")))
            p.start()
            procs.append((world, rank, p))
    t_start = time.perf_counter()

    def wait_f2():
        try:
            for _, _, p in procs:
                p.join(max(0.1, t_start + F_RANK_TIMEOUT_S - time.perf_counter()))
        finally:
            for _, _, p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        bad = [(w, r, p.exitcode) for w, r, p in procs if p.exitcode != 0]
        if bad:
            raise AssertionError(f"(f2) ranks failed or timed out (world, rank, exit code): {bad}")
        outs = {(w, r): torch.load(os.path.join(work, f"f2_out_{w}_{r}.pt"), map_location=dev)
                for w, r, _ in procs}
        return outs, time.perf_counter() - t_start

    return single, stats, wait_f2


def check_f2(torch, single, outs) -> dict:
    """(f2)'s results against the single-device ones; per-rank stats."""
    from scaloam_tpu_torch import config

    outer = config.kitti_hdl64().mapping.outer_iterations
    rows = {}
    for (world, rank), out in sorted(outs.items()):
        label = f"(f2) world {world} rank {rank}"
        diff = _check_sharded(label, torch, out, single)
        seq_m = float((out["mapped"][..., 4:] - single["mapped"][..., 4:]).abs().max())
        # one launch of each a batched frame, whatever the rank's sequences
        want = [F_SEQ_FRAMES, F_SEQ_FRAMES - 1, outer * F_SEQ_FRAMES]
        if not (seq_m <= F_SEQ_TOL_M and torch.isfinite(out["mapped"]).all()):
            raise AssertionError(f"{label}: multiseq mapped poses {seq_m:.2e} m from the "
                                 f"one-sequence run")
        if out["launches"] != want:
            raise AssertionError(f"{label}: launches K1/K2 A/K2 B {out['launches']}, want {want}")
        if world >= 4 and not (out["dryrun"]["layout"] == {"seq": 2, "kf": world // 2}
                               and torch.isfinite(out["dryrun"]["mapped"]).all()):
            raise AssertionError(f"{label}: dry run {out['dryrun']}")
        rows[f"{world}/{rank}"] = {"layout": out["layout"], "launches": out["launches"],
                                   "local_sequences": out["local_sequences"],
                                   "multiseq_s": out["multiseq_s"], "sharded_ms": out["ms"],
                                   "multiseq_max_m": seq_m, **diff}
    return rows


def backend_device_phase(torch, dev, root, cfg, scans, first, counters):
    """(f3): SlamSystem with a backend device over (b)'s first frames, held
    against (b); then run.main with --backend-device 0 (sync and
    --async-pipeline) and an index past the cards. Returns the stats."""
    import shutil

    from scaloam_tpu_torch import run
    from scaloam_tpu_torch.models.pipeline import SlamSystem

    bdev = "cuda:1" if torch.cuda.device_count() > 1 else str(dev)
    log(f"(f3) front end {dev}, backend device {bdev} ({torch.cuda.device_count()} CUDA devices)")
    s = SlamSystem(cfg, device=dev, backend_device=bdev)
    for counter in counters:
        counter.launches = 0
    mapped, kf = [], []
    for i, pts in enumerate(scans[:F_BACKEND_FRAMES]):
        r = s.process_scan(pts, time=0.1 * i)
        mapped.append(torch.cat([r.mapped_pose.quat, r.mapped_pose.trans]))
        kf.append(r.is_keyframe)
    launches = [c.launches for c in counters]
    mapped = torch.stack(mapped).cpu().numpy()
    opt = s.optimized_poses()
    stats = {"backend_device": bdev, "graph_device": str(s.graph.poses.quat.device),
             "keyframes": len(s.keyframes), "loops": s.loops_found, "launches": launches,
             "mapped_max_m": float(np.abs(mapped[:, 4:] - first["mapped"][:, 4:]).max()),
             "optimized_max_m": (float(np.abs(opt - first["optimized"]).max())
                                 if opt.shape == first["optimized"].shape else None)}
    want = [F_BACKEND_FRAMES, F_BACKEND_FRAMES - 1, cfg.mapping.outer_iterations * F_BACKEND_FRAMES]
    if not (kf == first["keyframe"] and s.loops_found == first["loops"]
            and stats["mapped_max_m"] <= F_SAME_TOL_M and stats["optimized_max_m"] is not None
            and stats["optimized_max_m"] <= F_SAME_TOL_M and launches == want
            and stats["graph_device"] == str(torch.device(bdev))):
        raise AssertionError(f"(f3) backend device against (b): {stats}, launches want {want}")
    base = ["--synthetic", "16", "--keyframe-gap", "1.0", "--synthetic-radius", "25",
            "--backend-device", "0"]
    stats["cli"] = []
    for extra in ([], ["--async-pipeline"]):
        out = os.path.join(root, "build", "smoke_backend")
        shutil.rmtree(out, ignore_errors=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(base + extra + ["--out", out])
        res = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else None
        if not (rc == 0 and res["keyframes"] >= 3 and "ate_rmse_optimized" in res):
            raise AssertionError(f"run.main --backend-device 0 {extra}: exit {rc}, {res}")
        stats["cli"].append(res)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = run.main(["--synthetic", "2", "--backend-device", "99"])
    if rc != 2 or "out of range" not in err.getvalue():
        raise AssertionError(f"run.main --backend-device 99: exit {rc}, {err.getvalue()!r}")
    return stats


def k1_cost(torch, feat, curv, sp, ep):
    """(bytes, operations) K1 needs on these rows: each input read and each
    output written once; per scanned point of a round, a flag test, the
    threshold and a max compare."""
    W = curv.shape[-1]
    rows = curv.numel() // W
    n_rounds = feat.less_sharp_per_subregion + feat.flat_per_subregion
    n_bytes = rows * W * (4 + 4 + 4 + 1) + 2 * sp.numel() * 4 + sp.numel() * n_rounds * 5 + rows * W
    scanned = n_rounds * int(torch.clamp(ep - sp + 1, min=0).sum())
    return n_bytes, 3 * scanned


def k2a_cost(odo, Nc, Ns, n_valid_c, n_valid_s):
    """(bytes, operations) of one entry-A problem with these valid counts."""
    n_bytes = Nc * (15 * 4 + 1) + Ns * (21 * 4 + 1) + 2 * 7 * 4 + 8
    n_ops = odo.outer_iterations * (
        Nc * K2_OPS_ASSOC[0] + Ns * K2_OPS_ASSOC[1]
        + odo.gn_iterations * (n_valid_c * K2_OPS_ITER[0] + n_valid_s * K2_OPS_ITER[1]))
    return n_bytes, n_ops


def k2b_cost(gn_iterations, Nc, Ns, n_valid_c, n_valid_s):
    """(bytes, operations) of one entry-B problem with these valid factors."""
    n_bytes = Nc * (9 * 4 + 1) + Ns * (7 * 4 + 1) + 2 * 7 * 4
    return n_bytes, gn_iterations * (n_valid_c * K2_OPS_ITER[0] + n_valid_s * K2_OPS_ITER[1])


def sq_dist_cost(Q, T):
    """(bytes, operations) of one [Q, T] distance block: the points read
    once, the block written once; per pair the dot's multiply and two fused
    multiply-adds (5), the sum, the doubling and the difference, and per
    point its squared norm (5)."""
    return (Q + T) * 12 + Q * T * 4, Q * T * 8 + (Q + T) * 5


def sweep_cost(Q, T, C):
    """(bytes, operations) of one sweep of Q queries over T targets in C
    classes: the points, mask and ring read once, two indices and points a
    query and class written; per pair and phase the distance (8, as
    sq_dist's less the norms) and a compare."""
    return Q * 12 + T * 17 + C * Q * 2 * (8 + 12), 2 * 9 * Q * T


# Each sensor's ring bounds (degrees of elevation) as the reference's
# _ring_id draws them, and its ring count.
RING_BOUNDS = {
    "VLP16": (16, [2.0 * k - 16.0 for k in range(17)]),
    "HDL32": (32, [4.0 * k / 3.0 - 92.0 / 3.0 for k in range(33)]),
    "HDL64": (64, [2.0 - (k + 0.5) / 3.0 for k in range(33)]
              + [-8.83 - (k + 0.5) / 2.0 for k in range(32)] + [2.0, -8.83, -24.33]),
    "OS1-64": (64, [2.0 * k - 23.5 for k in range(25)]),
}


def ring_bound_points(lidar_type, seed=0, per_bound=64):
    """float32 points [n, 3] whose elevation lies on one of the sensor's
    ring bounds, z moved by up to 3 float32 ulps: the ring id and its
    validity hang on the angle's last ulp there."""
    rng = np.random.default_rng(seed)
    el = np.radians(np.repeat(np.asarray(RING_BOUNDS[lidar_type][1]), per_bound))
    r = rng.uniform(5.0, 80.0, el.size)
    az = rng.uniform(-np.pi, np.pi, el.size)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
                   -1).astype(np.float32)
    xyz[:, 2] += rng.integers(-3, 4, el.size) * np.spacing(np.abs(xyz[:, 2]))
    return xyz


def former_ring_azimuth(torch, xyz, lidar_type, n_scans):
    """The sequence csrc/ring_azimuth.cu replaced: the port's ring id of a
    scan (~15 elementwise launches around csrc/f32ops.cu's atan2) and its
    raw azimuth twice (the sweep's scalars, then the sorted points'
    relative time: the same atan2 on the same points in another order)."""
    from scaloam_tpu_torch.ops import f32
    from scaloam_tpu_torch.ops.kernels import f32ops

    deg = 180.0 / np.pi
    x, y, z = xyz.unbind(-1)
    hyp = torch.sqrt(f32.fma_f32(x, x, y * y).double()).float()
    rad = f32ops.atan2(z, hyp)
    angle = rad * deg
    trunc = lambda v: torch.trunc(v).to(torch.int32)
    if lidar_type == "VLP16":
        sid = trunc(f32.fma_f32(rad, deg, 15.0) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL32":
        sid = trunc(f32.fma_f32(rad, deg, 92.0 / 3.0) * 3.0 / 4.0)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL64":
        upper = trunc((2.0 - angle) * 3.0 + 0.5)
        lower = n_scans // 2 + trunc((-8.83 - angle) * 2.0 + 0.5)
        sid = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:  # OS1-64
        sid = trunc(f32.fma_f32(rad, deg, 22.5) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    ori_raw = -f32ops.atan2(y, x)
    ori_sorted = -f32ops.atan2(y, x)  # the third call's cost: the same points sorted
    return torch.clamp(sid, 0, n_scans - 1), ok, ori_raw, ori_sorted


def rounding_checks(torch, dev, cfg, dev_scans, tag=""):
    """The kernels of csrc/f32ops.cu against their plain versions
    (ops/f32.py) and csrc/ring_azimuth.cu against its plain version
    (ops/kernels/ring_azimuth.py) on the card, bit for bit, on the largest
    input of each that one FrontEnd step of frame 1 (after frame 0) passes,
    captured as the step passes it: sq_dist on the larger odometry sweep's
    queries and first tile of targets (the block it wrote a tile before
    csrc/sweep_top2.cu took the sweeps), sum3_sq's largest batch of
    vectors, ring_azimuth's points; atan2 (off the path) on those points'
    azimuths. The two sweeps equal their plain version (the former
    composition) bit for bit, the larger timed beside it captured. Also sq_dist on a tie-heavy block
    of integer points, sum3_sq on integer vectors, atan2 on the quadrants,
    axes and signed zeros and ring_azimuth on the frame with its first rows
    on the sensor's ring bounds, and each under torch.func.vmap over those
    2 problems: one launch, equal to a launch a problem. ring_azimuth is
    timed captured beside the sequence it replaced (former_ring_azimuth)
    and the gather of its azimuths into the range image's order. Returns
    {name: {max_abs_err, ms, eager_ms, plain_ms, bound_ms, bound_by,
    library_ms, shape}}."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import f32, voxel
    from scaloam_tpu_torch.ops.kernels import f32ops, ring_azimuth, sweep_top2

    fe = FrontEnd(cfg, device=dev)
    with compiled.disabled():  # a captured step's replay runs no spy
        fe.step(dev_scans[0].xyz, dev_scans[0].mask)
    kernels = _front_counters()
    spied = {name: {"ring_azimuth": ring_azimuth, "sweep_top2": sweep_top2}.get(name, f32ops)
             for name in kernels}
    captured = {name: [] for name in kernels}

    def spy(name):
        def call(*args, **kw):
            args = inspect.signature(kernels[name]).bind(*args, **kw).args
            captured[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return kernels[name](*args)
        return call

    for name, mod in spied.items():
        setattr(mod, name, spy(name))
    try:
        with compiled.disabled():
            fe.step(dev_scans[1].xyz, dev_scans[1].mask)
    finally:
        for name, mod in spied.items():
            setattr(mod, name, kernels[name])
    if (captured["atan2"] or captured["sq_dist"] or len(captured["ring_azimuth"]) != 1
            or len(captured["sweep_top2"]) != 2):
        raise AssertionError(
            f"{tag}front-end step: {len(captured['atan2'])} atan2, {len(captured['sq_dist'])} "
            f"sq_dist, {len(captured['ring_azimuth'])} ring_azimuth and "
            f"{len(captured['sweep_top2'])} sweep_top2 calls; want 0, 0, 1 and 2")
    # the most outputs: the larger sweep's Q x T (sq_dist's block: the
    # sweep's first tile), sum3_sq's element count
    sweep = max(captured["sweep_top2"], key=lambda args: args[0].shape[0] * args[1].shape[0])
    q, t = sweep[0], sweep[1][:voxel.fit_tile(sweep[1].shape[0], sweep[6])]
    (v,) = max(captured["sum3_sq"], key=lambda args: args[0].numel())
    pts, lidar, n_scans = captured["ring_azimuth"][0]
    y, x = pts[:, 1].contiguous(), pts[:, 0].contiguous()
    Q, T = q.shape[0], t.shape[0]
    rng = np.random.default_rng(1)
    ints = lambda *shape: torch.tensor(rng.integers(-6, 7, shape), dtype=torch.float32, device=dev)
    special = torch.tensor(rng.uniform(-100, 100, (2, y.numel())), dtype=torch.float32,
                           device=dev).reshape(2, *y.shape)
    flat = special.view(2, -1)
    flat[0, :64], flat[1, 64:128], flat[0, 128:192] = 0.0, 0.0, -0.0
    bounds = torch.tensor(ring_bound_points(lidar), device=dev)[:pts.shape[0]]
    on_bounds = torch.cat([bounds, pts[bounds.shape[0]:]])
    cases = {"sq_dist": [("frame", (q, t)), ("ties", (ints(Q, 3), ints(T, 3)))],
             "sum3_sq": [("frame", (v,)), ("integers", (ints(*v.shape),))],
             "atan2": [("frame", (y, x)), ("quadrants", (special[0], special[1]))],
             "ring_azimuth": [("frame", (pts,)), ("ring bounds", (on_bounds,))]}
    statics = {"ring_azimuth": (lidar, n_scans)}
    plain = {"sq_dist": f32.sq_dist, "sum3_sq": f32.sum3_sq, "atan2": f32.atan2,
             "ring_azimuth": ring_azimuth.ring_azimuth_plain}
    library = {"sq_dist": None, "sum3_sq": lambda a: torch.linalg.vecdot(a, a),
               "atan2": torch.atan2, "ring_azimuth": None}
    n, P = v.numel() // 3, pts.shape[0]
    cost = {"sq_dist": sq_dist_cost(Q, T), "sum3_sq": (n * 16, n * 5),
            "atan2": (y.numel() * 12, y.numel() * ATAN2_OPS),
            "ring_azimuth": (P * 21, P * RING_AZIMUTH_OPS)}
    rows = {}
    for name in FRONT_KERNELS:
        kernel, extra = kernels[name], statics.get(name, ())
        for label, args in cases[name]:
            got, want = kernel(*args, *extra), plain[name](*args, *extra)
            for g, w in zip(*((got, want) if name == "ring_azimuth" else ((got,), (want,)))):
                if not _equal_bits(torch, g, w):
                    raise AssertionError(f"{tag}{name} {label} {tuple(args[0].shape)}: differs "
                                         f"from the plain version at {int((g != w).sum())} entries")
            msg = f"{tag}{name} {label} {tuple(args[0].shape)}: kernel == plain bit for bit"
            if library[name] is not None:
                msg += (f" (the library call rounds otherwise at "
                        f"{int((library[name](*args) != want).sum())} of {want.numel()})")
            log(msg)
        # both cases as one vmapped batch of 2
        batch = [torch.stack(pair) for pair in zip(cases[name][0][1], cases[name][1][1])]
        before = kernel.launches
        got = torch.func.vmap(lambda *a: kernel(*a, *extra))(*batch)
        launched = kernel.launches - before
        one = lambda i: kernel(*(a[i] for a in batch), *extra)
        same = lambda g, w: all(torch.equal(a, b) for a, b in zip(
            *((g, w) if name == "ring_azimuth" else ((g,), (w,)))))
        if launched != 1 or not all(same(pytree_index(got, i), one(i)) for i in range(2)):
            raise AssertionError(f"{tag}{name} vmapped over 2: {launched} launches, want 1 "
                                 f"equal to a launch a problem")
        args = cases[name][0][1]
        call = lambda: kernel(*args, *extra)
        rows[name] = dict(
            max_abs_err=0.0, ms=graph_ms(torch, call, 100), eager_ms=cuda_ms(torch, call, 200),
            plain_ms=cuda_ms(torch, lambda: plain[name](*args, *extra), 5),
            library_ms=(None if library[name] is None
                        else cuda_ms(torch, lambda: library[name](*args), 200)),
            shape=[list(a.shape) for a in args])
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound_ms(*cost[name])
        r = rows[name]
        log(f"{tag}{name} times {r['shape']}: kernel {r['ms']:.4f} ms (eager call "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")
    # ring_azimuth beside the sequence it replaced, and the gather of its
    # azimuths into the sorted order that took the third atan2's place
    r = rows["ring_azimuth"]
    ori = ring_azimuth.ring_azimuth(pts, lidar, n_scans)[2]
    perm = torch.randperm(P, device=dev)
    r["replaced_graph_ms"] = graph_ms(torch, lambda: former_ring_azimuth(
        torch, pts, lidar, n_scans), 20)
    r["gather_ms"] = graph_ms(torch, lambda: ori[perm], 100)
    log(f"{tag}ring_azimuth {[P, 3]} ({lidar}): kernel {r['ms']:.4f} ms + the azimuths' gather "
        f"{r['gather_ms']:.4f} ms, the sequence it replaced captured {r['replaced_graph_ms']:.4f} "
        f"ms")
    # the odometry's two sweeps (csrc/sweep_top2.cu) on the step's inputs
    # against their plain version, the former composition, bit for bit; the
    # larger timed beside that composition captured
    for args in captured["sweep_top2"]:
        got, want = sweep_top2.sweep_top2(*args), sweep_top2.sweep_top2_plain(*args)
        shape = f"{args[0].shape[0]} x {args[1].shape[0]}"
        if not (torch.equal(got[0], want[0]) and _equal_bits(torch, got[1], want[1])):
            raise AssertionError(f"{tag}sweep_top2 {shape}: differs from the plain version")
        log(f"{tag}sweep_top2 {shape} (want_same {args[5]}): kernel == plain bit for bit")
    call = lambda: sweep_top2.sweep_top2(*sweep)
    Q, T = sweep[0].shape[0], sweep[1].shape[0]
    r = rows["sweep_top2"] = dict(
        max_abs_err=0.0, ms=graph_ms(torch, call, 100), eager_ms=cuda_ms(torch, call, 200),
        plain_ms=cuda_ms(torch, lambda: sweep_top2.sweep_top2_plain(*sweep), 5), library_ms=None,
        replaced_graph_ms=graph_ms(torch, lambda: sweep_top2.sweep_top2_plain(*sweep), 10),
        shape=[[Q, 3], [T, 3]])
    r["bound_ms"], r["bound_by"] = bound_ms(*sweep_cost(Q, T, 2 + sweep[5]))
    log(f"{tag}sweep_top2 times {r['shape']}: kernel {r['ms']:.4f} ms (eager call "
        f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, the composition it replaced "
        f"captured {r['replaced_graph_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']})")
    return rows


def pytree_index(tree, i):
    """Row i of every tensor of a tensor or a tuple of tensors."""
    return tuple(t[i] for t in tree) if isinstance(tree, tuple) else tree[i]


def kabsch_cases(torch, dev, n=300):
    """Random, near-planar (s3 = 1e-6 s1), reflected (det < 0), rank-2 and
    zero 3x3 matrices on the card, seeded."""
    rng = np.random.default_rng(11)
    U, V = (np.linalg.qr(rng.normal(size=(n, 3, 3)))[0] for _ in range(2))
    s = np.sort(rng.uniform(0.1, 1.0, (n, 3)), axis=1)[:, ::-1] * rng.uniform(1, 1e3, (n, 1))
    planar, rank2 = s.copy(), s.copy()
    planar[:, 2], rank2[:, 2] = 1e-6 * s[:, 0], 0.0
    make = lambda sv: U @ (sv[:, :, None] * np.swapaxes(V, 1, 2))
    refl = make(s) * np.where(np.linalg.det(make(s)) > 0, -1.0, 1.0)[:, None, None]
    cases = {"random": rng.normal(size=(n, 3, 3)) * rng.uniform(0.1, 1e4, (n, 1, 1)),
             "near-planar": make(planar), "reflected": refl, "rank-2": make(rank2),
             "zero": np.zeros((8, 3, 3))}
    return {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in cases.items()}


def former_matvec(torch, odom, gps, loops, plans, v, damp, free):
    """The sequence csrc/hess_matvec.cu replaced: the optimise's matvec as
    the port composed it before that kernel (einsums, shifts, two
    csrc/segment_sum.cu sums) inside the CG's two masks."""
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.ops.kernels import segment_sum

    fm = free[:, None]
    v = torch.where(fm, v, 0.0)
    v_next = torch.cat([v[1:], torch.zeros_like(v[:1])])
    Av = torch.einsum("frc,fc->fr", odom.Ji, v) + torch.einsum("frc,fc->fr", odom.Jj, v_next)
    WAv = odom.W * Av
    out = damp * v + pg._JtWr(odom.Ji, WAv) + pg._shift_down(pg._JtWr(odom.Jj, WAv))
    out = out + pg._JtWr(gps.Ji, gps.W * torch.einsum("frc,fc->fr", gps.Ji, v))
    WAvl = loops.W * (torch.einsum("frc,fc->fr", loops.Ji, v[loops.i])
                      + torch.einsum("frc,fc->fr", loops.Jj, v[loops.j]))
    out = segment_sum.add(out, pg._JtWr(loops.Ji, WAvl), plans[0])
    out = segment_sum.add(out, pg._JtWr(loops.Jj, WAvl), plans[1])
    return torch.where(fm, out, 0.0)


def former_kabsch(torch, source, w, tgt, mask_q):
    """The sequence csrc/kabsch_step.cu replaced: ICP's step as the port
    composed it before that kernel, around csrc/kabsch.cu's rotation."""
    from scaloam_tpu_torch.ops import se3
    from scaloam_tpu_torch.ops.kernels import kabsch

    wsum = torch.clamp(torch.sum(w, dim=1), min=1.0)[:, None]
    mu_s = torch.sum(source[None] * w[..., None], dim=1) / wsum
    mu_t = torch.sum(tgt * w[..., None], dim=1) / wsum
    P = (source[None] - mu_s[:, None]) * w[..., None]
    Q = tgt - mu_t[:, None]
    if mask_q:
        Q = torch.where(w[..., None] > 0, Q, 0.0)
    R = kabsch.kabsch_rotation(torch.matmul(P.mT, Q))
    return se3.mat_to_quat(R), mu_t - torch.matmul(R, mu_s[..., None])[..., 0]


def former_chain_solve(torch, chain, b, free, mask_out):
    """The sequence csrc/chain_solve.cu replaced: blocktri.solve as the port
    composed it before that kernel (three batched matmuls, two
    subtractions, a slice update and a stack a level) inside the masks of
    its callers."""
    Do_inv, L, R, root = chain
    n, P = b.shape[0], Do_inv.shape[0] + 1
    vec = b.dim() == 2
    if free is not None:
        b = torch.where(free.reshape((n,) + (1,) * (b.dim() - 1)), b, 0.0)
    x = b[..., None] if vec else b
    if P != n:
        x = torch.cat([x, x.new_zeros((P - n,) + x.shape[1:])])
    levels, off, m = [], 0, P // 2
    while m >= 1:
        levels.append((Do_inv[off:off + m], L[off:off + m], R[off:off + m]))
        off, m = off + m, m // 2
    stack = []
    for D, Lm, Rm in levels:
        bo, be = x[1::2], x[0::2]
        Dinv_bo = torch.matmul(D, bo)
        x = be - torch.matmul(Lm, Dinv_bo)
        x[1:] -= torch.matmul(Rm.mT, Dinv_bo)[:-1]
        stack.append(bo)
    x = torch.matmul(root, x)
    for (D, Lm, Rm), bo in zip(reversed(levels), reversed(stack)):
        rhs = bo - torch.matmul(Lm.mT, x)
        rhs[:-1] -= torch.matmul(Rm[:-1], x[1:])
        xo = torch.matmul(D, rhs)
        x = torch.stack([x, xo], dim=1).reshape((2 * x.shape[0],) + x.shape[1:])
    x = x[:n]
    x = x[..., 0] if vec else x
    if mask_out:
        x = torch.where(free.reshape((n,) + (1,) * (x.dim() - 1)), x, 0.0)
    return x


def chain_solve_plain(torch, chain, b, free, mask_out):
    """chain_solve's plain version on a call's arguments (b [n, 6] or
    [n, 6, C])."""
    from scaloam_tpu_torch.ops.kernels import chain_solve

    vec = b.dim() == 2
    out = chain_solve.chain_solve_plain(*chain, b[..., None] if vec else b, free, mask_out)
    return out[..., 0] if vec else out


def chain_solve_row(torch, chain, b, free, mask_out, former_iters=20):
    """csrc/chain_solve.cu on one call's arguments: ms captured and eager,
    the plain version's ms, the captured ms of the sequence it replaced,
    and its bound (the levels, the root, b, free and the output each moved
    once; CHAIN_OPS_ROW a block row of a level and a column)."""
    from scaloam_tpu_torch.ops.kernels import chain_solve

    P, n = chain.Do_inv.shape[0] + 1, b.shape[0]
    C = 1 if b.dim() == 2 else b.shape[2]
    call = lambda: chain_solve.chain_solve(chain, b, free, mask_out)
    row = dict(shape=list(b.shape), padded_nodes=P, masked_in=free is not None,
               masked_out=mask_out, ms=graph_ms(torch, call, 100),
               eager_ms=cuda_ms(torch, call, 200),
               plain_ms=cuda_ms(torch, lambda: chain_solve_plain(torch, chain, b, free, mask_out),
                                5),
               replaced_graph_ms=graph_ms(torch, lambda: former_chain_solve(
                   torch, chain, b, free, mask_out), former_iters),
               library_ms=None)
    row["bound_ms"], row["bound_by"] = bound_ms(
        3 * (P - 1) * 144 + 144 + 2 * n * 24 * C + (0 if free is None else n),
        C * ((P - 1) * CHAIN_OPS_ROW + CHAIN_OPS_ROOT))
    return row


def woodbury_solve_checks(torch, dev):
    """csrc/chain_solve.cu on the wide solve of (a)'s Woodbury setup
    (C^-1 V, [N, 6, 6L]) at 1024 / 16 and 4096 / 64, eager and spied: bit
    for bit against the plain version, timed as chain_solve_row. Returns
    {"N x 6 x C": row}."""
    from scaloam_tpu_torch import compiled, config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.ops.kernels import chain_solve
    from scaloam_tpu_torch.types import Pose

    rows, kernel = {}, chain_solve.chain_solve
    for n, nl in PGO_TIERS:
        _, oq, ot, loops = circle_chain(n, nl, seed=n)
        cfg = chain_pgo_cfg(config.PGOConfig(), n, nl)
        if not pg.uses_woodbury(n, nl, cfg):
            continue
        g = build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev)
        ks = torch.arange(n, device=dev)
        free = (ks > 0) & (ks < g.n_nodes)
        calls = []

        def spy(*args):
            calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args[1:]))
            return kernel(*args)

        chain_solve.chain_solve = spy
        try:
            with compiled.disabled():
                factors = [pg._sanitize(f) for f in pg._linearize(g, cfg)]
                _, D, D_loop = pg._gradient_and_diag(factors, n, pg.loop_plans(g))
                wb = pg._woodbury_setup(factors, D, D_loop, free, cfg.lm_damping)
        finally:
            chain_solve.chain_solve = kernel
        (b, fr, mask_out), = calls
        chain = wb[0]
        if not _bits_equal(torch, kernel(chain, b, fr, mask_out),
                           chain_solve_plain(torch, chain, b, fr, mask_out)):
            raise AssertionError(f"chain_solve {tuple(b.shape)}: differs from the plain version")
        rows["x".join(map(str, b.shape))] = chain_solve_row(torch, chain, b, fr, mask_out, 3)
    return rows


def _bits_equal(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _equal_bits(torch, a, b) -> bool:
    """Float tensors equal bit for bit, others equal."""
    return _bits_equal(torch, a, b) if a.is_floating_point() else torch.equal(a, b)


def backend_kernel_checks(torch, dev, system, icp_call):
    """The keyframe backend's kernels against their plain versions on the
    card, on every input that one eager loop verification of (b)
    (`icp_call`, a recorded call of icp.verify_loop) and one eager optimise
    of (b)'s final graph pass them (spied): csrc/kabsch_step.cu (ICP's
    step), csrc/hess_matvec.cu (the CG's matvec) and csrc/chain_solve.cu
    (the CG's preconditioner, and the wide solve of (a)'s Woodbury setups,
    woodbury_solve_checks) bit for bit, each timed captured beside the
    captured sequence it replaced (former_kabsch, former_matvec,
    former_chain_solve) at the same inputs; csrc/kabsch.cu's rotation on the H's
    the plain step computes from the recorded inputs and on kabsch_cases,
    timed beside torch.linalg.svd (which reads the device from the host; its
    host syncs counted); csrc/segment_sum.cu on its remaining calls (the
    gradient's and diagonal's loop rows), timed beside index_add_ (float
    atomics), with whether index_add_ and index_put_(accumulate=True) sum
    in the kernel's order and are bit-equal run to run. Returns {name:
    row}."""
    import torch.utils._pytree as pytree

    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.ops import icp
    from scaloam_tpu_torch.ops.kernels import chain_solve, hess_matvec, kabsch, segment_sum

    names = {"segment_sum": (segment_sum, "add"), "hess_matvec": (hess_matvec, "hess_matvec"),
             "kabsch_step": (kabsch, "kabsch_step"), "kabsch": (kabsch, "kabsch_rotation"),
             "chain_solve": (chain_solve, "chain_solve")}
    kernels = {name: getattr(mod, attr) for name, (mod, attr) in names.items()}
    seen = {name: [] for name in names}
    clone = lambda t: t.clone() if torch.is_tensor(t) else t

    def spy(name):
        def call(*args, **kw):  # keywords are the wrappers' last parameters
            seen[name].append(pytree.tree_map(clone, args + tuple(kw.values())))
            return kernels[name](*args, **kw)
        return call

    for name, (mod, attr) in names.items():
        setattr(mod, attr, spy(name))
    try:
        with compiled.disabled():  # a captured step's replay runs no spy
            icp.verify_loop(*icp_call[0], **icp_call[1])
            pg.optimize(system.graph, system.cfg.pgo)
    finally:
        for name, (mod, attr) in names.items():
            setattr(mod, attr, kernels[name])
    if seen["kabsch"] or not (seen["kabsch_step"] and seen["hess_matvec"]
                              and seen["chain_solve"]):
        raise AssertionError(f"backend calls {[(k, len(v)) for k, v in seen.items()]}: want "
                             f"the step, the matvec and the chain solve, never the rotation "
                             f"alone")
    rows = {}
    # the Kabsch step: every call of the verification, bit for bit
    for src, w, tgt, mask_q in seen["kabsch_step"]:
        got = kabsch.kabsch_step(src, w, tgt, mask_q)
        want_q, want_t = kabsch.kabsch_step_plain(src[None], w, tgt, mask_q)
        if not (_bits_equal(torch, got.quat, want_q) and _bits_equal(torch, got.trans, want_t)):
            raise AssertionError(f"kabsch_step {tuple(w.shape)}: differs from the plain version")
    shapes = {}
    for call in seen["kabsch_step"]:  # the last call of each shape, coarse and fine
        shapes[tuple(call[1].shape)] = call
    step_rows = {}
    for shape, (src, w, tgt, mask_q) in shapes.items():
        B, S = shape
        r = dict(shape=[B, S], mask_q=mask_q,
                 ms=graph_ms(torch, lambda: kabsch.kabsch_step(src, w, tgt, mask_q), 100),
                 eager_ms=cuda_ms(torch, lambda: kabsch.kabsch_step(src, w, tgt, mask_q), 200),
                 plain_ms=cuda_ms(torch, lambda: kabsch.kabsch_step_plain(src[None], w, tgt,
                                                                          mask_q), 20),
                 replaced_graph_ms=graph_ms(torch, lambda: former_kabsch(torch, src, w, tgt,
                                                                         mask_q), 100),
                 library_ms=None)
        r["bound_ms"], r["bound_by"] = bound_ms(
            S * 12 + B * S * 16 + B * 28, B * (S * STEP_OPS_POINT + STEP_OPS_ROW))
        step_rows[f"{B}x{S}"] = r
    fine = max(step_rows.values(), key=lambda r: r["shape"][1])
    rows["kabsch_step"] = dict(fine, max_abs_err=0.0, calls=len(seen["kabsch_step"]),
                               shapes=step_rows)
    # the rotation: the H's of those steps (plain), one at a time and as one
    # batch, and the edge cases
    Hs = [kabsch.kabsch_step_parts(src[None], w, tgt, mask_q)[2]
          for src, w, tgt, mask_q in seen["kabsch_step"]]
    cases = {"verification": torch.cat(Hs), **kabsch_cases(torch, dev)}
    err = 0.0
    for label, H in cases.items():
        got, want = kabsch.kabsch_rotation(H), kabsch.kabsch_plain(H)
        e = float((got - want).abs().max())
        orth = float((got @ got.mT - torch.eye(3, device=dev)).abs().max())
        if not (e <= KABSCH_TOL and torch.isfinite(got).all() and orth < 1e-5):
            raise AssertionError(f"kabsch {label} {tuple(H.shape)}: {e:.3e} from plain "
                                 f"(tol {KABSCH_TOL}), |R R^T - I| {orth:.2e}")
        err = max(err, e)
        log(f"kabsch {label} {tuple(H.shape)}: |kernel - plain| {e:.3e} (tol {KABSCH_TOL}), "
            f"|R R^T - I| {orth:.2e}")
    if not all(_bits_equal(torch, kabsch.kabsch_rotation(h), kabsch.kabsch_plain(h)) for h in Hs):
        raise AssertionError("kabsch: the rotation of a verification step's H differs from plain")
    H = max(Hs, key=lambda h: h.shape[0])
    with SyncCounter(torch) as sc:
        torch.linalg.svd(H)
        svd_syncs = sc.count()
    rows["kabsch"] = dict(max_abs_err=err, shape=list(H.shape), calls=len(Hs),
                          ms=graph_ms(torch, lambda: kabsch.kabsch_rotation(H), 100),
                          eager_ms=cuda_ms(torch, lambda: kabsch.kabsch_rotation(H), 200),
                          plain_ms=cuda_ms(torch, lambda: kabsch.kabsch_plain(H), 20),
                          library_ms=cuda_ms(torch, lambda: torch.linalg.svd(H), 50),
                          library_host_syncs=svd_syncs)
    rows["kabsch"]["bound_ms"], rows["kabsch"]["bound_by"] = bound_ms(
        H.shape[0] * 72, H.shape[0] * KABSCH_OPS)
    # the matvec: every call of the optimise, bit for bit
    for args in seen["hess_matvec"]:
        got = hess_matvec.hess_matvec(*args)
        if not _bits_equal(torch, got, hess_matvec.hess_matvec_plain(*hess_matvec.operands(*args))):
            raise AssertionError(f"hess_matvec {tuple(args[4].shape)}: differs from the plain "
                                 f"version")
    args = seen["hess_matvec"][0]
    ops = hess_matvec.operands(*args)
    N = args[4].shape[0]
    ends = sum(int(p.starts[-1]) for p in args[3])  # the loop rows in the plans
    # the loop slots the plans reach (padding slots are in neither plan)
    slots = int(torch.unique(torch.cat([p.order[:int(p.starts[-1])] for p in args[3]])).numel())
    rows["hess_matvec"] = dict(
        max_abs_err=0.0, shape=[N, int(args[2].Ji.shape[0])], calls=len(seen["hess_matvec"]),
        loop_ends=ends, loop_slots=slots,
        ms=graph_ms(torch, lambda: hess_matvec.hess_matvec(*args), 100),
        eager_ms=cuda_ms(torch, lambda: hess_matvec.hess_matvec(*args), 200),
        plain_ms=cuda_ms(torch, lambda: hess_matvec.hess_matvec_plain(*ops), 20),
        replaced_graph_ms=graph_ms(torch, lambda: former_matvec(torch, *args), 100),
        library_ms=None)
    # bytes: the node arrays (v, damp, free, the odometry and GPS factors)
    # and both plans' starts whole, a reached slot's Ji, Jj, W, i and j
    # once, an order entry a planned row, the output
    node_bytes = sum(t.numel() * t.element_size() for t in ops[:8] + (ops[14], ops[16]))
    rows["hess_matvec"]["bound_ms"], rows["hess_matvec"]["bound_by"] = bound_ms(
        node_bytes + slots * (2 * 144 + 24 + 2 * 8) + ends * 8 + N * 24,
        N * HMV_OPS_NODE + ends * HMV_OPS_LOOP_END)
    # the chain solve: every call of the optimise, bit for bit, then (a)'s
    # Woodbury setups
    for chain, b, free, mask_out in seen["chain_solve"]:
        if not _bits_equal(torch, chain_solve.chain_solve(chain, b, free, mask_out),
                           chain_solve_plain(torch, chain, b, free, mask_out)):
            raise AssertionError(f"chain_solve {tuple(b.shape)}: differs from the plain version")
    chain, b, free, mask_out = seen["chain_solve"][0]
    rows["chain_solve"] = dict(chain_solve_row(torch, chain, b, free, mask_out), max_abs_err=0.0,
                               calls=len(seen["chain_solve"]))
    rows["chain_solve"]["shapes"] = {"x".join(map(str, b.shape)): {
        k: v for k, v in rows["chain_solve"].items() if k != "calls"},
        **woodbury_solve_checks(torch, dev)}
    # segment sums: every remaining call of the optimise, bit for bit
    for base, rws, plan in seen["segment_sum"]:
        got = segment_sum.add(base, rws, plan)
        if not _bits_equal(torch, got, segment_sum.add_plain(base, rws, *plan)):
            raise AssertionError(f"segment_sum {tuple(base.shape)} {tuple(rws.shape)}: differs "
                                 f"from the plain version")
    # the largest call with the most nodes that several rows reach
    shared = lambda p: int(((p.starts[1:] - p.starts[:-1]) > 1).sum())
    base, rws, plan = max(seen["segment_sum"], key=lambda c: (c[1].numel(), shared(c[2])))
    n, R = base.shape[0], rws.shape[0]
    counts = plan.starts[1:] - plan.starts[:-1]
    # the rows in the plan (padding rows are in none), by node, each node's
    # in ascending row order, for the library calls
    index = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    rows_in = rws[plan.order[:index.shape[0]]]
    ref = segment_sum.add(base, rws, plan)
    same = lambda x: torch.equal(x.view(torch.int32), ref.view(torch.int32))
    flat = lambda x: x.reshape(n, -1)
    adds = [base.index_add(0, index, rows_in) for _ in range(20)]
    puts = [base.index_put((index,), rows_in, accumulate=True) for _ in range(20)]
    rows["segment_sum"] = dict(
        max_abs_err=0.0, shape=[list(base.shape), list(rws.shape)], calls=len(seen["segment_sum"]),
        shared_nodes=shared(plan),
        ms=graph_ms(torch, lambda: segment_sum.add(base, rws, plan), 100),
        eager_ms=cuda_ms(torch, lambda: segment_sum.add(base, rws, plan), 200),
        plain_ms=cuda_ms(torch, lambda: segment_sum.add_plain(base, rws, *plan), 20),
        library_ms=cuda_ms(torch, lambda: base.index_add(0, index, rows_in), 200),
        index_add_in_order=sum(map(same, adds)), index_put_in_order=sum(map(same, puts)),
        index_add_run_to_run_equal=all(torch.equal(flat(a), flat(adds[0])) for a in adds),
        index_put_run_to_run_equal=all(torch.equal(flat(a), flat(puts[0])) for a in puts))
    c = rws[0].numel()
    rows["segment_sum"]["bound_ms"], rows["segment_sum"]["bound_by"] = bound_ms(
        2 * n * c * 4 + R * c * 4 + R * 8 + (n + 1) * 8, R * c)
    for name, r in rows.items():
        lib, rep = r["library_ms"], r.get("replaced_graph_ms")
        log(f"{name} {r['shape']} ({r['calls']} calls in one eager run): kernel {r['ms']:.4f} ms "
            f"(eager call {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            f"{'' if rep is None else f', the sequence it replaced captured {rep:.4f} ms'}; "
            + json.dumps({k: v for k, v in r.items() if k not in (
                "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                "replaced_graph_ms")}))
    return rows


def kernel_checks(torch, dev, cfg, dev_scans, tag=""):
    """Each kernel entry against its plain version at the shapes of cfg's
    frames (dev_scans, on the card), then timed. K1 on frame 1's selection
    inputs, the same frame as one subregion spanning each row (long lists)
    and a tie-heavy input: equal. K2 entry A on frame 1's cached
    candidates, a numpy-made scenario and the scenario with every mask
    off; entry B on the prepared factors mapping passes in at PREP_FRAME
    (a dense map) and with every factor off: within the K2 tolerances.
    Returns {"K1" | "K2 A" | "K2 B": {max_abs_err, ms, eager_ms, plain_ms,
    bound_ms, bound_by}}."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models import odometry
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import features, se3
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection
    from scaloam_tpu_torch.types import Pose

    feat = cfg.features
    rows = {}
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
                raise AssertionError(f"{tag}K1 {label}: {n} differs from the plain version "
                                     f"at {int((g != w).sum())} entries")
            k1_err = max(k1_err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        log(f"{tag}K1 {label} ({S} x {W}): kernel == plain on all {len(names)} outputs "
            f"({int(got[1].sum())} corner, {int(got[3].sum())} flat picks)")
    k1_call = lambda: selection.select_features(*frame_args, **sel_kw)
    k1_bytes, k1_ops = k1_cost(torch, feat, si.curv, si.sp, si.ep)
    rows["K1"] = dict(
        max_abs_err=k1_err, ms=graph_ms(torch, k1_call, 100), eager_ms=cuda_ms(torch, k1_call, 200),
        plain_ms=cuda_ms(torch, lambda: selection.select_features_plain(*frame_args, **sel_kw), 5))
    rows["K1"]["bound_ms"], rows["K1"]["bound_by"] = bound_ms(k1_bytes, k1_ops)
    log(f"{tag}K1 times: kernel {rows['K1']['ms']:.4f} ms (eager call "
        f"{rows['K1']['eager_ms']:.4f} ms), plain {rows['K1']['plain_ms']:.3f} ms, bound "
        f"{rows['K1']['bound_ms']:.6f} ms ({k1_bytes} B, {k1_ops} ops)")

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
        k2_err = max(k2_err, pose_err(torch, f"{tag}K2 A {label}", (q, t), (qp, tp), counts))
    if float((t - invalid[10]).abs().max()) > 1e-5:
        raise AssertionError(f"{tag}K2 A all-invalid: the pose moved")
    k2_call = lambda: gn_odometry.associate_and_solve(*frame_k2, **k2_kw)
    Nc, Ns = frame_k2[0].shape[0], frame_k2[4].shape[0]
    _, _, nc, ns = gn_odometry.associate_and_solve(*frame_k2, **k2_kw)
    k2_bytes, k2_ops = k2a_cost(odo, Nc, Ns, int(nc), int(ns))
    rows["K2 A"] = dict(
        max_abs_err=k2_err, ms=graph_ms(torch, k2_call, 100), eager_ms=cuda_ms(torch, k2_call, 200),
        plain_ms=cuda_ms(torch, lambda: gn_odometry.associate_and_solve_plain(*frame_k2, **k2_kw), 5))
    rows["K2 A"]["bound_ms"], rows["K2 A"]["bound_by"] = bound_ms(k2_bytes, k2_ops)
    log(f"{tag}K2 A times ({int(nc)}/{Nc} corner, {int(ns)}/{Ns} surf valid): kernel "
        f"{rows['K2 A']['ms']:.4f} ms (eager call {rows['K2 A']['eager_ms']:.4f} ms), plain "
        f"{rows['K2 A']['plain_ms']:.3f} ms, bound {rows['K2 A']['bound_ms']:.6f} ms "
        f"({k2_bytes} B, {k2_ops} ops), cluster "
        f"{gn_odometry.cluster_size(Nc, Ns, prepared=False)} blocks")

    # ---- K2 entry B: mapping's prepared factors of a frame with a dense
    # map (captured as mapping passes them in), and all-invalid factors
    captured = []
    kernel_b = gn_odometry.gn_solve_prepared

    def spy(*args, **kw):
        captured.append((args, kw))
        return gn_odometry.gn_solve_prepared_plain(*args, **kw)

    fe = FrontEnd(cfg, device=dev)
    with compiled.disabled():  # a captured step's replay runs no spy
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
        raise AssertionError(f"{tag}entry B input of frame {PREP_FRAME} has no valid factors")
    bad = list(prep_args)
    bad[5], bad[9] = torch.zeros_like(bad[5]), torch.zeros_like(bad[9])
    kb_err = 0.0
    for label, args in ((f"frame {PREP_FRAME}", prep_args), ("all-invalid", bad)):
        q, t = gn_odometry.gn_solve_prepared(*args, **prep_kw)
        qp, tp = gn_odometry.gn_solve_prepared_plain(*args, **prep_kw)
        torch.cuda.synchronize()
        nv = (int(args[5].sum()), int(args[9].sum()))
        kb_err = max(kb_err, pose_err(torch, f"{tag}K2 B {label}", (q, t), (qp, tp), (nv, nv)))
    if float((t - bad[1]).abs().max()) > 1e-5:
        raise AssertionError(f"{tag}K2 B all-invalid: the pose moved")
    kb_call = lambda: gn_odometry.gn_solve_prepared(*prep_args, **prep_kw)
    Nc, Ns = prep_args[2].shape[0], prep_args[6].shape[0]
    kb_bytes, kb_ops = k2b_cost(prep_kw["gn_iterations"], Nc, Ns, nvc, nvs)
    rows["K2 B"] = dict(
        max_abs_err=kb_err, ms=graph_ms(torch, kb_call, 100), eager_ms=cuda_ms(torch, kb_call, 200),
        plain_ms=cuda_ms(torch, lambda: gn_odometry.gn_solve_prepared_plain(*prep_args, **prep_kw), 5))
    rows["K2 B"]["bound_ms"], rows["K2 B"]["bound_by"] = bound_ms(kb_bytes, kb_ops)
    log(f"{tag}K2 B times ({nvc}/{Nc} corner, {nvs}/{Ns} surf factors valid): kernel "
        f"{rows['K2 B']['ms']:.4f} ms (eager call {rows['K2 B']['eager_ms']:.4f} ms), plain "
        f"{rows['K2 B']['plain_ms']:.3f} ms, bound {rows['K2 B']['bound_ms']:.6f} ms "
        f"({kb_bytes} B, {kb_ops} ops), cluster "
        f"{gn_odometry.cluster_size(Nc, Ns, prepared=True)} blocks")

    # ---- the rounding kernels on the inputs frame 1's step passes them
    rows.update(rounding_checks(torch, dev, cfg, dev_scans, tag))
    return rows


def frontend_drive(torch, dev, cfg, dev_scans, gt, tag=""):
    """cfg's front end through FrontEnd over dev_scans, the kernels' launch
    counts set to 0 just before and read just after: K1 once a frame, K2 A
    from the second frame on, K2 B outer_iterations times a frame. Mapped
    poses within MAX_TRANS_ERR_M of gt; a fired keyframe has a finite,
    non-empty cloud. Returns (ms/frame past WARM_FRAMES, launches, outputs,
    the drive in the recording's layout for phase (i))."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import features

    n = len(dev_scans)
    _zero_launches()
    fe = FrontEnd(cfg, device=dev)
    outs = []
    t_start = None
    for i, scan in enumerate(dev_scans):
        if i == WARM_FRAMES:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        outs.append(fe.step(scan.xyz, scan.mask))
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t_start) * 1e3 / (n - WARM_FRAMES)
    launches = _launch_counts()
    want = {"K1": n, "K2 A": n - 1, "K2 B": cfg.mapping.outer_iterations * n,
            "ring_azimuth": n, "atan2": 0, "sq_dist": 0, "sweep_top2": 2 * (n - 1)}
    _check_launches(f"{tag}front end ", launches, want)
    # The frames' features and K1's picks for (i), from the eager features
    # program on the same scans: a captured program's replay runs no spy
    # ((j) holds the captured features and picks equal to the eager ones).
    with compiled.disabled(), capture_frames() as frames:
        for scan in dev_scans:
            features.extract_features(scan, cfg)
    mapped = torch.stack([o.mapped_pose.trans for o in outs]).cpu().numpy()
    odom = torch.stack([o.odom_world.trans for o in outs]).cpu().numpy()
    quats = torch.stack([o.mapped_pose.quat for o in outs]).cpu().numpy()
    fires = [bool(o.fire) for o in outs]
    if not (np.isfinite(mapped).all() and np.isfinite(odom).all() and np.isfinite(quats).all()):
        raise AssertionError(f"{tag}non-finite pose on the front end")
    rel_gt = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])[:, :3, 3]
    err = np.linalg.norm(mapped - rel_gt, axis=1)
    if err.max() > MAX_TRANS_ERR_M:
        raise AssertionError(f"{tag}mapped translation error {err.max():.3f} m > {MAX_TRANS_ERR_M} m")
    for o, f in zip(outs, fires):
        n_kf = int(o.kf_mask.sum())
        if f and not (n_kf > 0 and torch.isfinite(o.kf_xyz[o.kf_mask]).all()):
            raise AssertionError(f"{tag}keyframe fired with an empty or non-finite cloud")
    log(f"{tag}front end: {n} frames, {sum(fires)} keyframes, launches {launches}, "
        f"{ms_frame:.2f} ms/frame over frames {WARM_FRAMES}-{n - 1}, max mapped-pose error "
        f"{err.max():.4f} m (mean {err.mean():.4f} m), final odom {odom[-1].round(3).tolist()}")
    return ms_frame, launches, outs, frontend_record(outs, frames)


def preset_phase(torch, dev, name, scans, gt):
    """(g1): the kernels at one preset's frame shapes against their plain
    versions, then the preset's front end over its drive, launches counted."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.types import LidarScan

    cfg = config.PRESETS[name]()
    dev_scans = [LidarScan.from_numpy(s, cfg.sensor.max_points, dev) for s in scans]
    tag = f"(g1) {name}: "
    log(f"{tag}{len(scans)} scans of {[len(s) for s in scans[:3]]}... points "
        f"(max_points {cfg.sensor.max_points}, {cfg.sensor.n_scans} x "
        f"{cfg.sensor.max_points_per_ring} range image)")
    rows = kernel_checks(torch, dev, cfg, dev_scans, tag)
    ms_frame, launches, _, record = frontend_drive(torch, dev, cfg, dev_scans, gt, tag)
    for key, row in rows.items():
        row["launches"] = launches[key]
    record["scan_sha256"] = [sha256_f32(x) for x in scans]
    return {"kernels": rows, "ms_per_frame": ms_frame, "record": record}


def write_mulran(seq, scans, gt):
    """A sequence in MulRan's layout (io/mulran.py): Ouster float32
    x, y, z, i quads named by nanosecond stamps at 10 Hz, gps.csv at 4 Hz
    (stamp, lat, lon, absolute altitude, covariance), global_pose.csv
    (stamp, 3 x 4 row-major pose). Returns the scans' stamps."""
    ouster = os.path.join(seq, "sensor_data", "Ouster")
    os.makedirs(ouster)
    stamps = G2_T0_NS + np.arange(len(scans), dtype=np.int64) * int(SENSOR_PERIOD_S * 1e9)
    rng = np.random.default_rng(0)
    for st, pts in zip(stamps, scans):
        quad = np.concatenate([pts[:, :3], rng.uniform(0, 1, (len(pts), 1))], 1)
        quad.astype(np.float32).tofile(os.path.join(ouster, f"{st}.bin"))
    gps_stamps = np.arange(G2_T0_NS, stamps[-1] + 1, 250_000_000, dtype=np.int64)
    with open(os.path.join(seq, "sensor_data", "gps.csv"), "w") as f:
        for st in gps_stamps:
            # the course is level: the fix reports the same absolute altitude
            f.write(f"{st},37.5,127.0,{G2_GPS_ALT_M:.4f},1.0,0,0,0,1.0,0,0,0,1.0\n")
    with open(os.path.join(seq, "global_pose.csv"), "w") as f:
        for st, T in zip(stamps, gt):
            f.write(f"{st}," + ",".join(f"{v:.9f}" for v in T[:3, :4].reshape(-1)) + "\n")
    return stamps


def mulran_ate(out, stamps, gt, ate_rmse) -> float:
    """ATE of a MulRan run's optimized_poses.txt against the course's poses
    (relative to its first), each keyframe matched to its scan through
    times.txt; `ate_rmse` is either package's utils.evaluation.ate_rmse."""
    est = np.loadtxt(os.path.join(out, "optimized_poses.txt")).reshape(-1, 3, 4)[:, :, 3]
    times = np.loadtxt(os.path.join(out, "times.txt")).reshape(-1)
    frames = np.abs(stamps[None, :] * 1e-9 - times[:, None]).argmin(axis=1)
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
    return ate_rmse(est, gt_rel[frames][:, :3, 3])


def mulran_cli_phase(torch, root, made, counters):
    """(g2): the README's MulRan usage, `run.main(["--preset",
    "mulran_os1_64", "--mulran-dir", d, "--use-gps", "--out", o])`, on a
    synthetic OS1-64 course written in MulRan's layout under build/. The
    system is recorded (frame times, keyframe flags), the optimise timed
    with its tier; launches counted. Exit 0, a loop, GPS factors, ATE."""
    import shutil

    from scaloam_tpu_torch import run
    from scaloam_tpu_torch.models import pipeline, posegraph
    from scaloam_tpu_torch.ops import icp
    from scaloam_tpu_torch.utils.evaluation import ate_rmse

    base = os.path.join(root, "build", "smoke_mulran")
    shutil.rmtree(base, ignore_errors=True)
    seq, out = os.path.join(base, "seq"), os.path.join(base, "out")
    scans, gt = [m[0] for m in made], np.stack([m[1] for m in made])
    stamps = write_mulran(seq, scans, gt)

    systems, frame_ms, kf_flags, opt_ms, tiers = [], [], [], [], set()
    verify, last = [], []
    optimize, verify_loop = posegraph.optimize, icp.verify_loop

    def timed_optimize(graph, cfg, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = optimize(graph, cfg, *a, **k)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        N, L = posegraph.node_capacity(graph), posegraph.loop_capacity(graph)
        tiers.add((N, L, "woodbury" if posegraph.uses_woodbury(N, L, cfg) else
                   "chain-CG" if N <= cfg.wb_max_nodes else "large chain-CG"))
        return new

    def spy_verify_loop(*a, **k):
        res = verify_loop(*a, **k)
        last.append(res[0])
        return res

    class Recorded(pipeline.SlamSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            systems.append(self)

        def process_scan(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = super().process_scan(*a, **k)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            kf_flags.append(r.is_keyframe)
            return r

        def _icp_verify(self, curr, loop_idx, yaw, poses=None):
            z = super()._icp_verify(curr, loop_idx, yaw, poses=poses)
            verify.append((curr, loop_idx, float(last[-1].fitness), z is not None))
            return z

    system_cls = pipeline.SlamSystem
    pipeline.SlamSystem, posegraph.optimize, icp.verify_loop = (
        Recorded, timed_optimize, spy_verify_loop)
    backend = _backend_counters()
    for counter in (*counters, *backend.values()):
        counter.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run.main(["--preset", "mulran_os1_64", "--mulran-dir", seq, "--use-gps",
                           "--out", out])
    finally:
        pipeline.SlamSystem, posegraph.optimize, icp.verify_loop = (
            system_cls, optimize, verify_loop)
    wall = time.perf_counter() - t0
    launches = dict(zip(("K1", "K2 A", "K2 B"), (c.launches for c in counters)))
    backend_launches = {name: c.launches for name, c in backend.items()}
    if rc != 0:
        raise AssertionError(f"(g2) run.main --preset mulran_os1_64: exit code {rc}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    (s,) = systems
    n = len(scans)
    want = {"K1": n, "K2 A": n - 1, "K2 B": s.cfg.mapping.outer_iterations * n}
    if launches != want:
        raise AssertionError(f"(g2) launches {launches}, want {want}")
    n_gps = int(s.graph.gps_valid.sum())
    est = np.loadtxt(os.path.join(out, "optimized_poses.txt")).reshape(-1, 3, 4)
    ate = mulran_ate(out, stamps, gt, ate_rmse)
    if not (res["frames"] == n and res["loops"] >= 1 and n_gps >= 1
            and s._gps_alt_offset == G2_GPS_ALT_M and len(est) == res["keyframes"]
            and np.isfinite(est).all() and ate <= SYS_ATE_MAX_M):
        raise AssertionError(f"(g2) {res}, {n_gps} GPS factors, altitude offset "
                             f"{s._gps_alt_offset}, ATE {ate:.4f} m")
    record = {
        "keyframes": np.array([kf.frame for kf in s.keyframes], np.int32),
        "verify": np.array([v[:2] for v in verify], np.int32).reshape(-1, 2),
        "verify_fitness": np.array([v[2] for v in verify], np.float32),
        "verify_accepted": np.array([v[3] for v in verify], bool),
        "loops": np.array(s.loops_found, np.int32).reshape(-1, 2), "gps_factors": n_gps,
        "optimized_poses": est, "ate_m": ate,
        "scan_sha256": [sha256_f32(x) for x in scans],
        "fitness_threshold": s.cfg.loop.fitness_threshold,
    }
    kf = np.asarray(kf_flags)
    ms = np.asarray(frame_ms)[2:]
    kf = kf[2:]
    return {
        "record": record,
        "result": res, "wall_s": wall, "gps_factors": n_gps, "ate_m": ate,
        "launches": launches, "backend_launches": backend_launches, "loops": s.loops_found,
        "ms_per_frame_keyframe_median": float(np.median(ms[kf])) if kf.any() else None,
        "ms_per_frame_non_keyframe_median": float(np.median(ms[~kf])) if (~kf).any() else None,
        "keyframe_frames": int(kf.sum()), "non_keyframe_frames": int((~kf).sum()),
        "optimise_calls": len(opt_ms), "optimise_ms_first": opt_ms[0] if opt_ms else None,
        "optimise_ms_median": float(np.median(opt_ms[1:])) if len(opt_ms) > 1 else None,
        "optimise_tiers": sorted(tiers),
        "graph_capacity": [posegraph.node_capacity(s.graph), posegraph.loop_capacity(s.graph)],
    }


def mapcloud_phase(torch, dev, system, kf_cloud):
    """(g3): map_points on (b)'s final mapping state against a host flatten
    of the same grids (same rows, same order); voxel_downsample on one
    full-width keyframe cloud, with and without a priority centre, against
    the same call on the CPU. Returns times and sizes."""
    from scaloam_tpu_torch.models import mapping
    from scaloam_tpu_torch.ops import voxel

    cfg, state = system.cfg, system.m_state
    m = cfg.mapping
    stats = {}
    clouds = mapping.map_points(state, cfg)
    for label, grid, (xyz, mask), cap in (
            ("corner", state.corner_grid, clouds[0], m.max_corner_map),
            ("surf", state.surf_grid, clouds[1], m.max_surf_map)):
        pts, count = grid.pts.cpu().numpy(), grid.count.cpu().numpy()
        C, K = pts.shape[:2]
        flat = pts.reshape(-1, 3)[(np.arange(K)[None, :] < count[:, None]).reshape(-1)][:cap]
        n = len(flat)
        got_xyz, got_mask = xyz.cpu().numpy(), mask.cpu().numpy()
        if not (got_xyz.shape == (cap, 3) and got_mask[:n].all() and not got_mask[n:].any()
                and np.array_equal(got_xyz[:n], flat) and not got_xyz[n:].any() and n > 0):
            raise AssertionError(f"(g3) map_points {label} differs from the host flatten")
        stats[label] = {"slots": C * K, "points": int(count.sum()), "capacity": cap, "kept": n}
    stats["map_points_ms"] = cuda_ms(torch, lambda: mapping.map_points(state, cfg), 5, warmup=1)

    xyz, mask = kf_cloud
    occupied = len(np.unique(np.floor(xyz[mask].cpu().numpy() / G3_VOXEL_M).astype(np.int64),
                             axis=0))
    cap = occupied // 2
    for label, center in (("plain", None), ("priority_center", torch.zeros(3, device=dev))):
        call = lambda x, mk, c: voxel.voxel_downsample(x, mk, G3_VOXEL_M, cap,
                                                       priority_center=c)
        got = call(xyz, mask, center)
        want = call(xyz.cpu(), mask.cpu(), None if center is None else center.cpu())
        if not torch.equal(got[1].cpu(), want[1]):
            raise AssertionError(f"(g3) voxel_downsample {label}: masks differ from the CPU")
        err = float((got[0].cpu() - want[0]).abs().max())
        if err > G3_TOL_M:
            raise AssertionError(f"(g3) voxel_downsample {label}: centroids {err:.2e} m off")
        stats[f"voxel_{label}"] = {
            "points": int(mask.sum()), "occupied_voxels": occupied, "capacity": cap,
            "kept": int(got[1].sum()), "max_abs_err_m": err,
            "ms": cuda_ms(torch, lambda: call(xyz, mask, center), 10, warmup=2)}
    return stats


def _qt(pose, torch):
    return torch.cat([pose.quat, pose.trans], dim=-1)


def _h_loop(torch, cfg, xyz, mask, capture=None):
    """(h)'s reference: every sequence through features -> odometry ->
    mapping alone, one frame of each sequence after the other (the
    single-sequence path). xyz [F, B, P, 3], mask [F, B, P]. With `capture`
    (a dict), the last frame's K2 A call and first K2 B call of each
    sequence record their arguments there. Returns (odometry poses
    [F, B, 7], mapped poses [F, B, 7], the feature clouds each frame leaves
    in the odometry state, ms per frame of all B sequences past the first)."""
    from scaloam_tpu_torch.models import mapping, odometry
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import gn_odometry
    from scaloam_tpu_torch.types import LidarScan

    F, B = xyz.shape[:2]
    dev = xyz.device
    states = [(odometry.init_state(cfg, dev), mapping.init_state(cfg, dev)) for _ in range(B)]
    odom, mapped, clouds = [], [], []
    kernels = (gn_odometry.associate_and_solve, gn_odometry.gn_solve_prepared)

    def spy(key, fn):
        def call(*a, **k):
            if key not in capture["seen"]:
                capture["seen"].add(key)
                capture[key].append(([x.clone() for x in a], k))
            return fn(*a, **k)
        return call

    t0 = None
    for f in range(F):
        if f == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        row_o, row_m, row_c = [], [], []
        for s in range(B):
            if capture is not None and f == F - 1:
                capture["seen"] = set()
                gn_odometry.associate_and_solve = spy("K2 A", kernels[0])
                gn_odometry.gn_solve_prepared = spy("K2 B", kernels[1])
            try:
                o, m = states[s]
                feats = features.extract_features(LidarScan(xyz[f, s], mask[f, s]), cfg)
                o, o_out = odometry.odometry_step(o, feats, cfg)
                m, m_out = mapping.mapping_step(m, o_out.world, feats.less_sharp,
                                                feats.less_flat, cfg)
            finally:
                gn_odometry.associate_and_solve, gn_odometry.gn_solve_prepared = kernels
            states[s] = (o, m)
            row_o.append(_qt(o_out.world, torch))
            row_m.append(_qt(m_out.pose, torch))
            row_c.append((o.last_corner, o.last_surf))
        odom.append(torch.stack(row_o))
        mapped.append(torch.stack(row_m))
        clouds.append(row_c)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (F - 1)
    return torch.stack(odom), torch.stack(mapped), clouds, ms


def _h_batched(torch, cfg, xyz, mask):
    """multiseq.frame_batch over the B = xyz.shape[1] sequences, one frame
    of all of them a call, the launches checked every frame: K1 1, K2 A 1
    (0 on the first frame), K2 B outer_iterations. Returns (odometry poses
    [F, B, 7], mapped poses [F, B, 7], the odometry states after each
    frame, ms per batched frame past the first)."""
    import torch.utils._pytree as pytree

    from scaloam_tpu_torch.parallel import multiseq

    F, B = xyz.shape[:2]
    o, m = multiseq.init_states(B, cfg, xyz.device)
    odom, mapped, states = [], [], []
    t0 = None
    for f in range(F):
        if f == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _zero_launches()
        o, m, o_pose, m_pose = multiseq.frame_batch(o, m, xyz[f], mask[f], cfg)
        # the first frame's odometry sweeps no candidates
        want = {"K1": 1, "K2 A": int(f > 0), "K2 B": cfg.mapping.outer_iterations,
                "ring_azimuth": 1, "atan2": 0, "sq_dist": 0, "sweep_top2": 2 * int(f > 0)}
        _check_launches(f"(h) B={B} frame {f}: ", _launch_counts(), want)
        odom.append(_qt(o_pose, torch))
        mapped.append(_qt(m_pose, torch))
        # the states are donated (updated in place by the next frame)
        states.append(pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, o))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (F - 1)
    return torch.stack(odom), torch.stack(mapped), states, ms


def _h_profile(torch, cfg, xyz, mask):
    """The last frame of xyz's sequences as one batched frame under
    torch.profiler, after the earlier frames unprofiled: wall ms, device ms
    (kernel time summed), kernels launched, idle share, and the five ops
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from scaloam_tpu_torch.parallel import multiseq

    o, m = multiseq.init_states(xyz.shape[1], cfg, xyz.device)
    for f in range(xyz.shape[0] - 1):
        o, m, _, _ = multiseq.frame_batch(o, m, xyz[f], mask[f], cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        multiseq.frame_batch(o, m, xyz[-1], mask[-1], cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_op = {}
    for e in kernels:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_ms": device, "kernels": len(kernels),
            "idle_share": 1 - device / wall, "top_kernels_ms": [[k[:60], v] for k, v in top]}


def _h_pose_diff(torch, got, want):
    """Largest |dq| (sign aligned) and |dt| between [..., 7] poses."""
    sign = torch.where((got[..., :4] * want[..., :4]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return (float((got[..., :4] * sign - want[..., :4]).abs().max()),
            float((got[..., 4:] - want[..., 4:]).abs().max()))


def _h_kernel(torch, key, batched, single, plain, equal, n_problems, cost, tag="(h) "):
    """One batched entry at B = n_problems: its single launch counted, bit
    equal to a launch a problem (`single(b)`), held against its plain version
    (`equal(got, plain())` returns the largest difference, raising past the
    tolerance), timed in a CUDA graph beside n_problems times the single
    launch. Returns the row for the kernel table."""
    _zero_launches()
    got = batched()
    torch.cuda.synchronize()
    if _launch_counts()[key] != 1:
        raise AssertionError(f"{tag}{key} batched: {_launch_counts()[key]} launches, want 1")
    for b in range(n_problems):
        one = single(b)
        for i, (g, w) in enumerate(zip(got, one)):
            if not torch.equal(g[b], w):
                raise AssertionError(f"{tag}{key} batched output {i} of problem {b} differs "
                                     "from its own launch")
    err = equal(got, plain())
    ms = graph_ms(torch, batched, 50)
    single_ms = graph_ms(torch, lambda: single(0), 50)
    row = {"max_abs_err": err, "ms": ms, "single_ms": single_ms,
           "plain_ms": cuda_ms(torch, plain, 2, warmup=1), "bit_equal_per_problem": True}
    row["bound_ms"], row["bound_by"] = bound_ms(*cost)
    log(f"{tag}{key} batched at B={n_problems}: 1 launch, bit-equal to {n_problems} single "
        f"launches, within {err:.2e} of the plain version; {ms:.4f} ms in a CUDA graph "
        f"against {n_problems} x {single_ms:.4f} = {n_problems * single_ms:.4f} ms single, "
        f"plain {row['plain_ms']:.2f} ms, bound {row['bound_ms']:.6f} ms ({cost[0]} B, "
        f"{cost[1]} ops, by {row['bound_by']})")
    return row


def multiseq_phase(torch, dev, cfg, dev_scans):
    """(h): the batched multi-sequence front end on the card at full width.
    H_SEQ sequences, sequence s frames s .. s + H_FRAMES - 1 of the main
    path's drive, in a world of one without a mesh: `multiseq.frame_batch`
    (one vmapped step over the stacked states) against each sequence through
    the same stages alone (equal feature clouds, so equal K1 picks; poses
    within H_Q_TOL / H_T_TOL), launches K1 1, K2 A 1 (0 on the first frame),
    K2 B 2 a batched frame; ms per batched frame at each of H_BATCHES
    beside the loop's; the B = H_SEQ drive's peak memory; each batched
    kernel entry at B = H_SEQ bit-equal to a launch a problem and held
    against its plain version. vmap's per-sample fallback warning is an
    error throughout. Returns (stats, kernel rows)."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import gn_odometry, selection
    from scaloam_tpu_torch.parallel import multiseq
    from scaloam_tpu_torch.types import LidarScan

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=multiseq.FALLBACK_WARNING)
        xyz = torch.stack([torch.stack([dev_scans[s + f].xyz for s in range(H_SEQ)])
                           for f in range(H_FRAMES)])
        mask = torch.stack([torch.stack([dev_scans[s + f].mask for s in range(H_SEQ)])
                            for f in range(H_FRAMES)])
        capture = {"K2 A": [], "K2 B": []}
        with compiled.disabled():  # a captured step's replay runs no spy
            want_o, want_m, want_c, _ = _h_loop(torch, cfg, xyz, mask, capture)
        _h_loop(torch, cfg, xyz, mask)  # captures the stages' programs
        _, _, _, loop_ms = _h_loop(torch, cfg, xyz, mask)

        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got_o, got_m, states, _ = _h_batched(torch, cfg, xyz, mask)
        peak = torch.cuda.max_memory_allocated(dev)
        for f, (o, row) in enumerate(zip(states, want_c)):
            for s, (corner, surf) in enumerate(row):
                for name, a, b in (("less-sharp", o.last_corner, corner),
                                   ("less-flat", o.last_surf, surf)):
                    for field in a._fields:
                        if not torch.equal(getattr(a, field)[s], getattr(b, field)):
                            raise AssertionError(f"(h) frame {f} sequence {s}: the {name} "
                                                 f"cloud's {field} differs from the loop's")
        dq_o, dt_o = _h_pose_diff(torch, got_o, want_o)
        dq_m, dt_m = _h_pose_diff(torch, got_m, want_m)
        if not (dq_o <= H_Q_TOL and dt_o <= H_T_TOL and dq_m <= H_Q_TOL and dt_m <= H_T_TOL):
            raise AssertionError(f"(h) batched vs loop: odometry |dq| {dq_o:.2e} |dt| {dt_o:.2e}, "
                                 f"mapped |dq| {dq_m:.2e} |dt| {dt_m:.2e}")
        moved = float(want_m[-1, :, 4:].norm(dim=-1).min())
        log(f"(h) frame_batch over {H_SEQ} sequences x {H_FRAMES} frames: feature clouds "
            f"(K1's picks) equal to the loop's on every frame; largest difference odometry "
            f"|dq| {dq_o:.2e} |dt| {dt_o:.2e} m, mapped |dq| {dq_m:.2e} |dt| {dt_m:.2e} m "
            f"(tol {H_Q_TOL} / {H_T_TOL}); least distance driven {moved:.2f} m; launches a "
            f"batched frame K1 1, K2 A 1 (0 on the first), K2 B "
            f"{cfg.mapping.outer_iterations}; peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before)")
        if not moved > 1.0:
            raise AssertionError(f"(h) the sequences did not move ({moved:.3f} m)")

        # Timed on replays: a drive at each batch size captures its programs
        # first (at H_SEQ, the drive above).
        ms_batched = {}
        for B in H_BATCHES:
            sub = xyz[:, :B].contiguous(), mask[:, :B].contiguous()
            if B != H_SEQ:
                _h_batched(torch, cfg, *sub)
            ms_batched[B] = _h_batched(torch, cfg, *sub)[3]
        log("(h) ms per batched frame (frames 1-3): " + ", ".join(
            f"B={B} {ms_batched[B]:.2f} ({ms_batched[B] / B:.2f} a sequence)"
            for B in H_BATCHES) + f"; the loop over {H_SEQ} sequences {loop_ms:.2f} "
            f"({loop_ms / H_SEQ:.2f} a sequence), {loop_ms / ms_batched[H_SEQ]:.2f}x the "
            f"batched B={H_SEQ}; captured programs, timed on replays")
        profiled = {B: _h_profile(torch, cfg, xyz[:, :B], mask[:, :B]) for B in (1, H_SEQ)}
        for B, pr in profiled.items():
            log(f"(h) one batched frame of B={B} under the profiler: wall {pr['wall_ms']:.2f} ms, "
                f"device {pr['device_ms']:.2f} ms, {pr['kernels']} kernels, idle share "
                f"{pr['idle_share']:.3f}; most device time: {pr['top_kernels_ms']}")

        # ---- the batched kernel entries at B = H_SEQ
        feat, odo = cfg.features, cfg.odometry
        sel_kw = dict(n_sub=feat.n_subregions, n_corner=feat.less_sharp_per_subregion,
                      n_flat=feat.flat_per_subregion, curv_thr=feat.curvature_threshold)
        si = [features.selection_inputs(LidarScan(xyz[-1, s], mask[-1, s]), cfg)
              for s in range(H_SEQ)]
        k1_args = tuple(torch.stack([getattr(x, n) for x in si]) for n in (
            "curv", "left_ext", "right_ext", "eligible", "sp", "ep"))
        S, W = k1_args[0].shape[1:]

        def k1_equal(got, want):
            want = [w.reshape(H_SEQ, S, *w.shape[1:]) for w in want]
            for i, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"(h) K1 batched output {i} differs from the plain "
                                         f"version at {int((g != w).sum())} entries")
            return 0

        rows = {"K1": _h_kernel(
            torch, "K1", lambda: torch.func.vmap(
                lambda *a: selection.select_features(*a, **sel_kw))(*k1_args),
            lambda b: selection.select_features(*(a[b] for a in k1_args), **sel_kw),
            lambda: selection.select_features_plain(
                *(a.reshape(H_SEQ * S, *a.shape[2:]) for a in k1_args), **sel_kw),
            k1_equal, H_SEQ, k1_cost(torch, feat, k1_args[0], k1_args[4], k1_args[5]))}

        def pose_equal(label):
            def check(got, want):
                err = 0.0
                for b in range(H_SEQ):
                    counts = None
                    if len(got) == 4:
                        counts = ((int(got[2][b]), int(got[3][b])),
                                  (int(want[b][2]), int(want[b][3])))
                    err = max(err, pose_err(torch, f"(h) {label} problem {b}",
                                            (got[0][b], got[1][b]), want[b][:2], counts))
                return err
            return check

        a_args, a_kw = capture["K2 A"][0][0], capture["K2 A"][0][1]
        a_args = [torch.stack([c[0][i] for c in capture["K2 A"]]) for i in range(len(a_args))]
        Nc, Ns = a_args[0].shape[1], a_args[4].shape[1]
        assoc = lambda: torch.func.vmap(
            lambda *a: gn_odometry.associate_and_solve(*a, **a_kw))(*a_args)
        valid = assoc()
        cost = [k2a_cost(odo, Nc, Ns, int(valid[2][b]), int(valid[3][b])) for b in range(H_SEQ)]
        rows["K2 A"] = _h_kernel(
            torch, "K2 A", assoc,
            lambda b: gn_odometry.associate_and_solve(*(a[b] for a in a_args), **a_kw),
            lambda: [gn_odometry.associate_and_solve_plain(*(a[b] for a in a_args), **a_kw)
                     for b in range(H_SEQ)],
            pose_equal("K2 A"), H_SEQ, tuple(map(sum, zip(*cost))))

        b_args, b_kw = capture["K2 B"][0][0], capture["K2 B"][0][1]
        b_args = [torch.stack([c[0][i] for c in capture["K2 B"]]) for i in range(len(b_args))]
        Nc, Ns = b_args[2].shape[1], b_args[6].shape[1]
        cost = [k2b_cost(b_kw["gn_iterations"], Nc, Ns, int(b_args[5][b].sum()),
                         int(b_args[9][b].sum())) for b in range(H_SEQ)]
        rows["K2 B"] = _h_kernel(
            torch, "K2 B", lambda: torch.func.vmap(
                lambda *a: gn_odometry.gn_solve_prepared(*a, **b_kw))(*b_args),
            lambda b: gn_odometry.gn_solve_prepared(*(a[b] for a in b_args), **b_kw),
            lambda: [gn_odometry.gn_solve_prepared_plain(*(a[b] for a in b_args), **b_kw)
                     for b in range(H_SEQ)],
            pose_equal("K2 B"), H_SEQ, tuple(map(sum, zip(*cost))))
        clusters = {}
        for key, (nc, ns, prep) in (("K2 A", (a_args[0].shape[1], a_args[4].shape[1], False)),
                                    ("K2 B", (Nc, Ns, True))):
            clusters[key] = (gn_odometry.cluster_size(nc, ns, prep),
                             gn_odometry.max_active_clusters(nc, ns, prep))
            log(f"(h) {key}: clusters of {clusters[key][0]} blocks, "
                f"cudaOccupancyMaxActiveClusters {clusters[key][1]}: a batch of {H_SEQ} runs "
                f"in {-(-H_SEQ // clusters[key][1])} wave(s)")
    stats = {"sequences": H_SEQ, "frames": H_FRAMES, "ms_per_batched_frame": ms_batched,
             "loop_ms_per_frame": loop_ms, "peak_bytes": peak, "base_bytes": base,
             "odometry_diff": (dq_o, dt_o), "mapped_diff": (dq_m, dt_m),
             "clusters": clusters, "profiled": profiled}
    launches = {"K1": H_FRAMES, "K2 A": H_FRAMES - 1,
                "K2 B": cfg.mapping.outer_iterations * H_FRAMES}
    for key, row in rows.items():
        row["launches"] = launches[key]
    return stats, rows

# ---- (j): the captured programs against eager


def _j_runs(torch, drive, eager=J_EAGER_RUNS):
    """drive(syncs, profile_at) -> (tensors, {program: Stage}), run eagerly
    `eager` times ("eager", "eager 2", ...), then captured, each under the
    sync counter; the first eager run and the captured one profile a call
    of each program. Returns {mode: result}."""
    from scaloam_tpu_torch import compiled

    runs = {}
    for mode in ["eager"] + [f"eager {i}" for i in range(2, eager + 1)] + ["captured"]:
        with contextlib.ExitStack() as ctx:
            if mode != "captured":
                ctx.enter_context(compiled.disabled())
            syncs = ctx.enter_context(SyncCounter(torch))
            runs[mode] = drive(syncs, J_PROFILE_AT if mode in ("eager", "captured") else None)
        torch.cuda.synchronize()
    return runs


def _bits(torch, x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _fdiff(torch, a, b) -> float:
    """Largest |a - b|, 0 where both are the same NaN, inf where one is."""
    d = (a.double() - b.double()).abs()
    same = torch.eq(_bits(torch, a), _bits(torch, b))
    return float(torch.where(same, 0.0, d.nan_to_num(nan=float("inf"))).max()) if d.numel() else 0.0


def j_compare(torch, label, runs):
    """The captured run's tensors against the eager runs' ({mode: list}):
    where the eager runs are bit-equal throughout the drive, the captured
    run bit-equal to them. Otherwise (a float sum whose order changes run
    to run) every integer and bool tensor equal to the first eager run's,
    and the captured run's largest float difference from its nearest
    eager run within the largest difference between two eager runs (the
    spread). Returns the tensors compared, how many are bit-equal to the
    first eager run, the largest difference from the nearest eager run
    and the spread."""
    cap, eager = runs["captured"], [x for m, x in runs.items() if m != "captured"]
    if not (len(cap) > 0 and all(len(e) == len(cap) for e in eager)):
        raise AssertionError(f"(j) {label}: {len(cap)} tensors, eager {[len(e) for e in eager]}")
    same = lambda a, b: torch.equal(_bits(torch, a), _bits(torch, b))
    largest = lambda xs, ys: max((_fdiff(torch, a, b) for a, b in zip(xs, ys)
                                  if a.is_floating_point()), default=0.0)
    eager_equal = all(same(a, b) for e in eager[1:] for a, b in zip(eager[0], e))
    spread = max(largest(a, b) for i, a in enumerate(eager) for b in eager[i + 1:])
    n_equal = 0
    for i, (c, a) in enumerate(zip(cap, eager[0])):
        if c.shape != a.shape or c.dtype != a.dtype:
            raise AssertionError(f"(j) {label}: tensor {i} is {c.dtype} {tuple(c.shape)}, "
                                 f"eager {a.dtype} {tuple(a.shape)}")
        if same(c, a):
            n_equal += 1
        elif eager_equal or not c.is_floating_point():
            raise AssertionError(f"(j) {label}: tensor {i} ({c.dtype} {tuple(c.shape)}) differs "
                                 f"from eager, and the eager runs agree on it")
    nearest = min(largest(cap, e) for e in eager)
    if nearest > spread:
        raise AssertionError(f"(j) {label}: {nearest:.3e} from the nearest eager run, past the "
                             f"eager runs' spread {spread:.3e}")
    return {"tensors": len(cap), "bit_equal": n_equal, "max_diff": nearest,
            "eager_spread": spread, "eager_runs_bit_equal": eager_equal}


def _tensors(torch, tree):
    import torch.utils._pytree as pytree

    return [x for x in pytree.tree_leaves(tree) if torch.is_tensor(x)]


def _j_frontend(torch, dev, cfg, dev_scans):
    """The main path's frames through FrontEnd (the step to the gate and the
    keyframe prep), then the features program and K1 (with its inputs) on
    the same scans."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import selection

    feat = cfg.features

    def k1(scan):
        si = features.selection_inputs(scan, cfg)
        return selection.select_features(
            si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep,
            n_sub=feat.n_subregions, n_corner=feat.less_sharp_per_subregion,
            n_flat=feat.flat_per_subregion, curv_thr=feat.curvature_threshold)

    picks = compiled.jit(k1)

    def drive(syncs, profile_at):
        fe = FrontEnd(cfg, device=dev)
        progs = {"front end frame": fe.step,
                 "features": lambda s: features.extract_features(s, cfg),
                 "K1 and its inputs": picks}
        progs = {k: Stage(torch, k, fn, syncs, profile_at) for k, fn in progs.items()}
        outs = [progs["front end frame"](s.xyz, s.mask) for s in dev_scans]
        feats = [progs["features"](s) for s in dev_scans]
        k1_out = [progs["K1 and its inputs"](s) for s in dev_scans]
        return {"front end": _tensors(torch, outs), "features": _tensors(torch, feats),
                "K1 picks": _tensors(torch, k1_out)}, progs

    return _j_runs(torch, drive)


def _j_system(torch, dev, cfg, scans):
    """The first J_SYS_FRAMES of (b) through SlamSystem: the sync driver's
    stage programs, the gate, the keyframe prep and the optimise at the
    graph's first tier, each call timed."""
    from scaloam_tpu_torch.models import mapping, odometry, pipeline, posegraph
    from scaloam_tpu_torch.ops import features

    names = (("features", features, "extract_features"),
             ("odometry", odometry, "odometry_step"), ("mapping", mapping, "mapping_step"),
             ("gate", pipeline, "gate_step"), ("keyframe prep", pipeline, "_prepare_keyframe"),
             ("optimise", posegraph, "optimize"))

    def drive(syncs, profile_at):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        s = pipeline.SlamSystem(cfg, device=dev)
        progs = {name: Stage(torch, name, getattr(mod, attr), syncs, profile_at)
                 for name, mod, attr in names}
        for name, mod, attr in names:
            setattr(mod, attr, progs[name])
        try:
            results = [s.process_scan(pts, time=0.1 * i) for i, pts in enumerate(scans)]
        finally:
            for name, mod, attr in names:
                setattr(mod, attr, progs[name].fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        out = [x for r in results for x in (r.odom_pose.quat, r.odom_pose.trans,
                                            r.mapped_pose.quat, r.mapped_pose.trans)]
        out.append(torch.tensor([r.is_keyframe for r in results]))
        out += [torch.from_numpy(np.asarray(kf.cloud)) for kf in s.keyframes]
        out += [torch.from_numpy(np.asarray(kf.intensity)) for kf in s.keyframes]
        out.append(torch.from_numpy(s.optimized_poses()))
        out.append(torch.tensor(s.loops_found or [(-1, -1)]))
        return {"system": out, "peak": peak}, progs

    return _j_runs(torch, drive)


def _j_batch(torch, cfg, xyz, mask):
    """(h)'s H_SEQ sequences over H_FRAMES frames through
    multiseq.frame_batch: poses each frame and the final stacked states."""
    from scaloam_tpu_torch.parallel import multiseq

    def drive(syncs, profile_at):
        torch.cuda.reset_peak_memory_stats(xyz.device)
        base = torch.cuda.memory_allocated(xyz.device)
        o, m = multiseq.init_states(xyz.shape[1], cfg, xyz.device)
        prog = Stage(torch, "frame_batch", lambda *a: multiseq.frame_batch(*a, cfg), syncs,
                     profile_at)
        poses = []
        for f in range(xyz.shape[0]):
            o, m, op, mp = prog(o, m, xyz[f], mask[f])
            poses += [op.quat.clone(), op.trans.clone(), mp.quat.clone(), mp.trans.clone()]
        peak = torch.cuda.max_memory_allocated(xyz.device) - base
        return {"batch": poses + _tensors(torch, (o, m)), "peak": peak}, {"frame_batch": prog}

    return _j_runs(torch, drive)


def _j_verify(torch, calls):
    """(b)'s recorded loop verifications through icp.verify_loop, each with
    the one read of its result that SlamSystem._icp_verify makes."""
    from scaloam_tpu_torch.ops import icp

    def verify(args, kwargs):
        res, coarse = icp.verify_loop(*args, **kwargs)
        out = [res.transform.quat, res.transform.trans, res.fitness, res.converged, coarse]
        return out + [torch.cat([res.fitness.reshape(1), res.transform.quat]).cpu()]

    calls = (calls * 4)[:max(4, len(calls))]  # enough calls to profile one and time others

    def drive(syncs, profile_at):
        prog = Stage(torch, "ICP verify", verify, syncs, profile_at)
        return {"ICP verify": [x for a, k in calls for x in prog(a, k)]}, {"ICP verify": prog}

    return _j_runs(torch, drive)


def _j_scancontext(torch, dev, cfg, clouds):
    """ScanContext over (b)'s first keyframe clouds as SlamSystem drives it:
    make_and_append each (growing the database past its first tier of 16),
    then detect_latest once the database can answer."""
    from scaloam_tpu_torch.models import scancontext as scm

    sc_cfg = cfg.scancontext

    def drive(syncs, profile_at):
        make = Stage(torch, "SC make_and_append", scm.make_and_append, syncs, profile_at)
        # (detection starts at num_exclude_recent; its profiled call is past the growth at 32)
        detect = Stage(torch, "SC detect_latest", scm.detect_latest, syncs,
                       None if profile_at is None else profile_at + 4)
        db, out = scm.init_db(sc_cfg, dev, initial=16), []
        for n, (xyz, mask) in enumerate(clouds):
            if n >= db.descriptors.shape[0]:
                db = scm.grow_db(db, 2 * db.descriptors.shape[0])
            db, sc = make(db, xyz, mask, sc_cfg)
            out.append(sc)
            if n >= sc_cfg.num_exclude_recent:
                out += list(detect(db, sc_cfg))
        return {"ScanContext": out + list(db)}, {"SC make_and_append": make,
                                                 "SC detect_latest": detect}

    return _j_runs(torch, drive)


def _j_appends(torch, dev, cfg, poses, loops):
    """The graph's appends through their host wrappers: (b)'s keyframe
    odometry poses from a graph of 64 nodes (grown on the way; node
    J_NEW_SEQUENCE_AT starts a sequence), then (b)'s loops."""
    from scaloam_tpu_torch.models import posegraph as pg

    def drive(syncs, profile_at):
        add_kf = Stage(torch, "graph add_keyframe", pg.add_keyframe, syncs, profile_at)
        add_loop = Stage(torch, "graph add_loop", pg.add_loop, syncs, profile_at)
        g = pg.init_graph(cfg.pgo, dev, initial_nodes=64, initial_loops=64)
        for k, p in enumerate(poses):
            g = add_kf(g, p, 0.0, False, n_nodes=k, new_sequence=k == J_NEW_SEQUENCE_AT)
        for m, (i, j, z) in enumerate(loops):
            g = add_loop(g, i, j, z, n_loops=m)
        return {"appends": _tensors(torch, g)}, {"graph add_keyframe": add_kf,
                                                  "graph add_loop": add_loop}

    return _j_runs(torch, drive)


def _j_optimise(torch, dev, tiers=PGO_TIERS):
    """(a)'s first optimise at each tier on its circle chain; returns
    (the runs, per tier every run's largest position difference from the
    JAX recording R4, which must lie within I_PGO_TOL_M)."""
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.types import Pose

    _, arrays = load_reference()
    chains = []
    for n, nl in tiers:
        _, oq, ot, loops = circle_chain(n, nl, seed=n)
        want = drive_arrays(arrays, f"R4.{n}")
        check_hashes(f"(j) R4.{n}", [want["chain_sha256"]], [chain_sha256(oq, ot, loops)])
        cfg = chain_pgo_cfg(config.PGOConfig(), n, nl)
        chains.append((n, cfg, build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev),
                       want["trans"]))

    def drive(syncs, profile_at):
        out, progs = {}, {}
        for n, cfg, g, _ in chains:
            prog = progs[f"optimise {n}"] = Stage(
                torch, f"optimise {n}", lambda g, cfg=cfg: pg.optimize(g, cfg), syncs,
                None if profile_at is None else 1)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            got = prog(g)
            out[f"optimise {n}"] = _tensors(torch, got)
            out[f"positions {n}"] = got.poses.trans.cpu().numpy()
            out[f"peak {n}"] = torch.cuda.max_memory_allocated(dev) - base
            if profile_at is not None:  # the second call is profiled
                prog(g)
        return out, progs

    runs = _j_runs(torch, drive)
    recording = {}
    for n, _, _, want in chains:
        d = {m: float(np.abs(run[0][f"positions {n}"] - want).max()) for m, run in runs.items()}
        if not max(d.values()) <= I_PGO_TOL_M:
            raise AssertionError(f"(j) optimise {n}: positions from the recording {d} m "
                                 f"(tol {I_PGO_TOL_M})")
        recording[n] = d
    return runs, recording


def captured_phase(torch, dev, cfg, dev_scans, sys_cfg, sys_scans, sys_stats):
    """(j): every captured program against itself eager, over the main
    path's frames, (b)'s first J_SYS_FRAMES, (b)'s keyframe backend (its
    recorded loop verifications, ScanContext and the graph's appends over
    its keyframes), (h) at H_SEQ sequences and (a)'s tiers: outputs held by
    j_compare, per program the ms a call, host launches, device operations
    and host reads, eager beside captured, and the peak memory above what
    was held before each of the (b), (h) and (a) drives."""
    from scaloam_tpu_torch.models.pipeline import _padded
    from scaloam_tpu_torch.types import Pose

    system = sys_stats["system"]
    kf_cap = sys_cfg.pgo.keyframe_cloud_capacity
    clouds = [_padded(kf.cloud[:kf_cap], kf_cap, dev) for kf in system.keyframes[:J_SC_KEYFRAMES]]
    n_kf, odom = len(system.keyframes), system.graph.odom_poses
    poses = [Pose(odom.quat[k].clone(), odom.trans[k].clone()) for k in range(n_kf)]
    rel = system.graph.loop_rel
    loops = [(i, j, Pose(rel.quat[m].clone(), rel.trans[m].clone()))
             for m, (i, j) in enumerate(system.loops_found)]
    xyz = torch.stack([torch.stack([dev_scans[s + f].xyz for s in range(H_SEQ)])
                       for f in range(H_FRAMES)])
    mask = torch.stack([torch.stack([dev_scans[s + f].mask for s in range(H_SEQ)])
                        for f in range(H_FRAMES)])
    drives = {"main path": _j_frontend(torch, dev, cfg, dev_scans),
              "(b)": _j_system(torch, dev, sys_cfg, sys_scans[:J_SYS_FRAMES]),
              "(b) ICP verify": _j_verify(torch, sys_stats["icp_calls"]),
              "(b) ScanContext": _j_scancontext(torch, dev, sys_cfg, clouds),
              "(b) graph appends": _j_appends(torch, dev, sys_cfg, poses, loops),
              "(h)": _j_batch(torch, cfg, xyz, mask)}
    drives["(a)"], recording = _j_optimise(torch, dev)
    stats = {"outputs": {}, "programs": {}, "peak_bytes": {}, "a_from_recording_m": recording}
    for drive, runs in drives.items():
        for key, value in runs["captured"][0].items():
            if key.startswith("peak"):
                stats["peak_bytes"][f"{drive} {key}"] = {m: runs[m][0][key]
                                                         for m in ("eager", "captured")}
                continue
            if key.startswith("positions"):
                continue
            stats["outputs"][f"{drive} {key}"] = j_compare(
                torch, f"{drive} {key}", {m: run[0][key] for m, run in runs.items()})
        for name in runs["captured"][1]:
            stats["programs"][f"{drive} {name}"] = {m: runs[m][1][name].summary()
                                                    for m in ("eager", "captured")}
    stats["reserved_bytes"] = torch.cuda.memory_reserved(dev)
    stats["graph_pool_bytes"] = graph_pool_bytes(torch)
    stats["eager_runs"] = J_EAGER_RUNS
    return stats


def reference_phase(main_record, g1, g2, pgo_rows):
    """(i): the outputs the earlier phases produced (the main path, (g1),
    (g2), (a)'s first optimise) against the JAX package's recorded runs of
    the same configurations, input hashes first. Returns the largest
    differences per drive."""
    meta, arrays = load_reference()
    log(f"(i) reference: {REFERENCE_NPZ} recorded by {meta['tool']} at commit "
        f"{meta['commit']} ({json.dumps(meta['versions'])}; {meta['kernels']})")
    out = {}
    fronts = [("R1", main_record)] + [(f"R2.{name}", g1[name]["record"]) for name, _ in G_PRESETS]
    for drive, got in fronts:
        want = drive_arrays(arrays, drive)
        check_hashes(drive, want["scan_sha256"], got["scan_sha256"])
        out[drive] = compare_frontend(drive, want, got)
    want = drive_arrays(arrays, "R3")
    got = g2["record"]
    check_hashes("R3", want["scan_sha256"], got["scan_sha256"])
    out["R3"] = compare_mulran(want, got, got["fitness_threshold"])
    rows = {f"R4.{row['nodes']}": row for row in pgo_rows}
    for drive in sorted({k.rsplit(".", 1)[0] for k in arrays if k.startswith("R4.")}):
        want, row = drive_arrays(arrays, drive), rows[drive]
        check_hashes(drive, [want["chain_sha256"]], [row["chain_sha256"]])
        out[drive] = compare_pose_graph(row["nodes"], want["trans"], row["first_trans"])
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
        presets = pool.map_async(_preset_drive_job, G_PRESETS)
        mulran = pool.map_async(_mulran_scan_job, range(G2_FRAMES))
        return _main(torch, drive, skewed, presets, mulran)
    finally:
        pool.terminate()
        pool.join()


def _main(torch, drive, skewed, presets, mulran) -> int:
    t_script = time.perf_counter()

    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.ops.kernels import _build, gn_odometry, selection
    from scaloam_tpu_torch.types import LidarScan
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
    t0 = time.perf_counter()
    scans, gt = preset_drive(synthetic, cfg.sensor, MAIN_COLS)
    dev_scans = [LidarScan.from_numpy(s, cap, dev) for s in scans]
    torch.cuda.synchronize()
    log(f"data: {N_FRAMES} scans of {[len(s) for s in scans[:3]]}... points "
        f"in {time.perf_counter() - t0:.1f} s")

    rows = kernel_checks(torch, dev, cfg, dev_scans)
    phase_wall(torch, f"build and kernel checks {time.perf_counter() - t_checks:.1f} s")

    # ---- main path: the full-width front end, launches counted
    t_phase = time.perf_counter()
    _, main_launches, outs, main_record = frontend_drive(torch, dev, cfg, dev_scans, gt,
                                                         "main path: ")
    main_record["scan_sha256"] = [sha256_f32(x) for x in scans]
    kf_out = next(o for o in outs if bool(o.fire))
    kf_cloud = (kf_out.kf_xyz, kf_out.kf_mask)  # for (g3)
    phase_wall(torch, f"front end {time.perf_counter() - t_phase:.1f} s")

    # ---- (a) the pose graph at users' sizes
    t_phase = time.perf_counter()
    pgo_rows = pose_graph_phase(torch, dev)
    phase_wall(torch, f"(a) pose graph {time.perf_counter() - t_phase:.1f} s")

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
    sys_stats = system_phase(torch, dev, sys_cfg, scans, sys_gt,
                             counters + tuple(_backend_counters().values()))
    launches = dict(zip(("K1", "K2 A", "K2 B") + BACKEND_KERNELS, sys_stats["launches"]))
    want = {"K1": SYS_FRAMES, "K2 A": SYS_FRAMES - 1,
            "K2 B": config.kitti_hdl64().mapping.outer_iterations * SYS_FRAMES}
    if ({k: launches[k] for k in want} != want or launches["kabsch"] != 0
            or min(launches[k] for k in PATH_BACKEND_KERNELS) < 1):
        raise AssertionError(f"system drive launches {launches}, want {want}, each of "
                             f"{PATH_BACKEND_KERNELS} at least once and kabsch (the rotation "
                             f"alone) never")
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
    icp_ms, icp_st = sys_stats["icp_ms"], sys_stats["stages"]["icp verify"]
    log(f"system ICP verify: {len(icp_ms)} calls timed, ms a call median "
        f"{np.median(icp_ms[1:] if len(icp_ms) > 1 else icp_ms):.2f} after the first "
        f"(eager, then captured: {icp_ms[0]:.2f}), host reads a call "
        f"{icp_st['host_syncs_mean']:.2f}, host launches {icp_st['host_launches']}, device "
        f"operations {icp_st['launches']}; keyframe median "
        f"{sys_stats['ms_per_frame_keyframe_median']:.2f} ms")
    bk_rows = backend_kernel_checks(torch, dev, sys_stats["system"], sys_stats["icp_calls"][0])
    non_kf, kf_ms, fe_ms = clean_frame_times(torch, dev, sys_cfg, scans[:CLEAN_FRAMES])
    sys_stats["clean"] = {"frames": CLEAN_FRAMES, "system_non_keyframe_ms": non_kf.tolist(),
                          "system_keyframe_ms": kf_ms.tolist(), "frontend_ms": fe_ms.tolist()}
    log(f"uninstrumented, frames 2-{CLEAN_FRAMES - 1} of the drive: SlamSystem non-keyframe "
        f"median {np.median(non_kf):.2f} ms ({len(non_kf)} frames), keyframe median "
        f"{np.median(kf_ms):.2f} ms ({len(kf_ms)}), all frames mean "
        f"{np.mean(np.concatenate([non_kf, kf_ms])):.2f} ms (a keyframe's optimise runs on "
        f"after its frame returns); FrontEnd.step + upload median {np.median(fe_ms):.2f} ms")
    phase_wall(torch, f"(b) system {time.perf_counter() - t_drive:.1f} s")

    # ---- (c) the CLI, then resumed
    t_phase = time.perf_counter()
    cli = cli_phase(os.getcwd())
    log(f"cli: {json.dumps(cli[0])}")
    log(f"cli resumed: {json.dumps(cli[1])}")
    log(f"cli --async-pipeline: {json.dumps(cli[2])}")
    phase_wall(torch, f"(c) CLI {time.perf_counter() - t_phase:.1f} s")

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
        phase_wall(torch, f"(d1) async {st['topology']} {time.perf_counter() - t_phase:.1f} s")

    # ---- (d2) the fused runtime at the sensor's rate over the whole drive
    t_phase = time.perf_counter()
    rt, got = realtime_phase(torch, dev, sys_cfg, scans, sys_gt,
                             counters + tuple(_backend_counters().values()))
    d2_launches = dict(zip(("K1", "K2 A", "K2 B") + BACKEND_KERNELS, got))
    log(f"(d2) real time: {json.dumps(rt)}, launches {d2_launches}")
    log(f"(d2) {rt['scans_per_sec']:.2f} scans/s, {rt['dropped_frames']} dropped, front end "
        f"{rt['frontend_ms_per_frame']:.2f} ms/frame busy, optimise {rt['optimise_calls']} calls "
        f"(first {rt['optimise_ms_first']:.1f} ms, median {rt['optimise_ms_median']:.1f} ms), "
        f"ICP {rt['icp_calls']} calls, loops {len(rt['loops'])}, ATE {rt['ate_opt_m']:.4f} m, "
        f"gate_wait {rt['stage_busy_s']['gate_wait']:.2f} s")
    phase_wall(torch, f"(d2) real time {time.perf_counter() - t_phase:.1f} s")

    # ---- (e) de-skew on skewed full-width frames
    t_phase = time.perf_counter()
    sk_scans, sk_gt = skewed.get()
    dk = deskew_phase(torch, dev, sk_scans, sk_gt, counters)
    log(f"(e) de-skew: {json.dumps(dk)} (launches K1, K2 A, K2 B)")
    phase_wall(torch, f"(e) de-skew {time.perf_counter() - t_phase:.1f} s")

    # ---- (f) the multi-device layer: (f1) a world of one over NCCL here,
    # (f2) ranks on the one card over gloo, run beside (f3) the backend device
    t_phase = time.perf_counter()
    dev0 = torch.device("cuda", 0)
    single, f1, wait_f2 = multidevice_phase(torch, dev0, os.getcwd(), sys_stats, scans)
    log(f"(f1) {json.dumps(f1)}")
    phase_wall(torch, f"(f1) and (f2)'s start {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    try:
        f3 = backend_device_phase(torch, dev0, os.getcwd(), sys_cfg, scans,
                                  sys_stats["first_frames"], counters)
    finally:
        outs, f2_wall = wait_f2()
    log(f"(f3) {json.dumps(f3)}")
    log(f"(f3) launches K1 / K2 A / K2 B {f3['launches']}")
    phase_wall(torch, f"(f3) backend device {time.perf_counter() - t_phase:.1f} s "
        f"(beside (f2))")
    for key, row in check_f2(torch, single, outs).items():
        log(f"(f2) world/rank {key}: {json.dumps(row)}")
        log(f"(f2) world/rank {key}: launches K1 / K2 A / K2 B {row['launches']} for "
            f"{row['local_sequences']} sequence(s) of {F_SEQ_FRAMES} frames")
    phase_wall(torch, f"(f2) ranks {f2_wall:.1f} s from their start")

    # ---- (g) the other presets at full width, the README's MulRan usage,
    # the map clouds and the generic voxel filter
    t_g = t_phase = time.perf_counter()
    g1 = {}
    for (name, _), (p_scans, p_gt) in zip(G_PRESETS, presets.get()):
        g1[name] = preset_phase(torch, dev, name, p_scans, p_gt)
    phase_wall(torch, f"(g1) presets {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    g2 = mulran_cli_phase(torch, os.getcwd(), mulran.get(), counters)
    log(f"(g2) {json.dumps({k: v for k, v in g2.items() if k != 'record'})}")
    log(f"(g2) run.main --preset mulran_os1_64 --mulran-dir --use-gps: "
        f"{g2['result']['frames']} frames, {g2['result']['keyframes']} keyframes, loops "
        f"{g2['loops']}, {g2['gps_factors']} GPS factors, ATE {g2['ate_m']:.4f} m, "
        f"launches {g2['launches']}; ms/frame keyframe median "
        f"{g2['ms_per_frame_keyframe_median']}, non-keyframe median "
        f"{g2['ms_per_frame_non_keyframe_median']}; optimise {g2['optimise_calls']} calls "
        f"(first {g2['optimise_ms_first']:.1f} ms, median {g2['optimise_ms_median']:.1f} ms) "
        f"at tiers (nodes, loops, solver) {g2['optimise_tiers']}")
    phase_wall(torch, f"(g2) MulRan CLI {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    g3 = mapcloud_phase(torch, dev, sys_stats["system"], kf_cloud)
    log(f"(g3) {json.dumps(g3)}")
    phase_wall(torch, f"(g3) map clouds and voxel filter {time.perf_counter() - t_phase:.1f} s; "
        f"(g) {time.perf_counter() - t_g:.1f} s")

    # ---- (h) the batched multi-sequence front end over the main path's frames
    t_phase = time.perf_counter()
    h_stats, h_rows = multiseq_phase(torch, dev, cfg, dev_scans)
    log(f"(h) {json.dumps(h_stats)}")
    phase_wall(torch, f"(h) batched multi-sequence front end {time.perf_counter() - t_phase:.1f} s")

    # ---- (j) the captured programs against eager
    t_phase = time.perf_counter()
    j = captured_phase(torch, dev, cfg, dev_scans, sys_cfg, scans, sys_stats)
    for name, row in j["outputs"].items():
        spread = ("bit-equal" if row["eager_runs_bit_equal"]
                  else f"apart by {row['eager_spread']:.3e}")
        log(f"(j) {name}: {row['tensors']} tensors, {row['bit_equal']} bit-equal to eager, "
            f"largest difference {row['max_diff']:.3e} (eager runs {spread})")
    for n, row in j["a_from_recording_m"].items():
        log(f"(j) (a) optimise {n}: positions from the JAX recording R4, per run (m): "
            f"{json.dumps(row)} (tol {I_PGO_TOL_M})")
    for name, row in j["programs"].items():
        e, c = row["eager"], row["captured"]
        log(f"(j) {name}: ms a call eager {e['ms_median']:.3f} / captured {c['ms_median']:.3f} "
            f"(medians, {e['calls']} calls, one profiled); host launches "
            f"{e['host_launches']} / {c['host_launches']}, device operations {e['launches']} / "
            f"{c['launches']}, host reads a call {e['host_syncs_mean']:.2f} / "
            f"{c['host_syncs_mean']:.2f}")
    for name, row in j["peak_bytes"].items():
        log(f"(j) {name} memory above what was held before: "
            + ", ".join(f"{m} {v / 2**30:.3f} GiB" for m, v in row.items()))
    pools = j["graph_pool_bytes"]
    log(f"(j) memory reserved by the caching allocator: {j['reserved_bytes'] / 2**30:.3f} GiB, "
        f"of it in graph pools: "
        f"{'not measured' if pools is None else f'{pools / 2**30:.3f} GiB'}")
    log(f"(j) {json.dumps(j)}")
    phase_wall(torch, f"(j) captured against eager {time.perf_counter() - t_phase:.1f} s")

    # ---- (i) the full-width runs above against the recorded JAX runs
    t_phase = time.perf_counter()
    ref = reference_phase(main_record, g1, g2, pgo_rows)
    log(f"(i) {json.dumps(ref)}")
    phase_wall(torch, f"(i) against the recorded JAX runs {time.perf_counter() - t_phase:.1f} s")
    from scaloam_tpu_torch import compiled

    pools = graph_pool_bytes(torch)
    log(f"graph pools at the script's end: "
        f"{'not measured' if pools is None else f'{pools / 2**30:.2f} GiB'} (PR 10 run 11: 3.53 "
        f"GiB), keys held {sum(len(st._cache) for st in compiled._steps)}, keys of outgrown "
        f"tiers dropped {sum(st.dropped for st in compiled._steps)}")
    log(f"script wall: {time.perf_counter() - t_script:.1f} s")

    gn_src = "scaloam_tpu_torch/csrc/gn_odometry.cu"
    meta = {
        "K1": {"name": "select_features", "source": "scaloam_tpu_torch/csrc/selection.cu",
               "replaces": "scaloam_tpu/ops/pallas/selection.py:96"},
        "K2 A": {"name": "associate_and_solve", "source": gn_src,
                 "replaces": "scaloam_tpu/ops/pallas/gn_odometry.py:316"},
        "K2 B": {"name": "gn_solve_prepared", "source": gn_src,
                 "replaces": "scaloam_tpu/models/mapping.py:187"},
    }
    kernels = []
    for key, m in meta.items():
        row = rows[key]
        kernels.append({
            "name": m["name"], "route": "cuda", "source": m["source"], "replaces": m["replaces"],
            "launches": launches[key], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "eager_ms": row["eager_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "matched": True,
            "g1": {name: {k: g1[name]["kernels"][key][k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
                for name in g1},
            "launches_g2": g2["launches"][key]})
    f32_src = "scaloam_tpu_torch/csrc/f32ops.cu"
    for key, source, replaces in (
            ("sq_dist", f32_src, "scaloam_tpu/ops/voxel.py:534"),
            ("sum3_sq", f32_src, "scaloam_tpu/ops/gridmap.py:230"),
            ("atan2", f32_src, "scaloam_tpu/ops/features.py:52"),
            ("ring_azimuth", "scaloam_tpu_torch/csrc/ring_azimuth.cu",
             "scaloam_tpu/ops/features.py:49"),
            ("sweep_top2", "scaloam_tpu_torch/csrc/sweep_top2.cu",
             "scaloam_tpu/models/odometry.py:68")):
        row = rows[key]
        kernels.append({
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[key], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "eager_ms": row["eager_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "matched": True, "shape": row["shape"],
            **{k: row[k] for k in ("replaced_graph_ms", "gather_ms") if k in row},
            "g1": {name: {k: g1[name]["kernels"][key][k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
                for name in g1}})
    for key, source, replaces in (
            ("kabsch", "scaloam_tpu_torch/csrc/kabsch.cu", "scaloam_tpu/ops/icp.py:122"),
            ("segment_sum", "scaloam_tpu_torch/csrc/segment_sum.cu",
             "scaloam_tpu/models/posegraph.py:439"),
            ("hess_matvec", "scaloam_tpu_torch/csrc/hess_matvec.cu",
             "scaloam_tpu/models/posegraph.py:447"),
            ("kabsch_step", "scaloam_tpu_torch/csrc/kabsch_step.cu",
             "scaloam_tpu/ops/icp.py:113"),
            ("chain_solve", "scaloam_tpu_torch/csrc/chain_solve.cu",
             "scaloam_tpu/ops/blocktri.py:201")):
        row = bk_rows[key]
        kernels.append({
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "eager_ms": row["eager_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "matched": True, "shape": row["shape"],
            "replaced_graph_ms": row.get("replaced_graph_ms"),
            "launches_a": {r["nodes"]: r["kernel_launches_per_optimise"][key] for r in pgo_rows},
            "launches_d2": d2_launches[key], "launches_g2": g2["backend_launches"][key],
            **({"shapes": row["shapes"]} if "shapes" in row else {})})
    for key, m in meta.items():
        row = h_rows[key]
        kernels.append({
            "name": f"{m['name']} batched (B={H_SEQ})", "route": "cuda", "source": m["source"],
            "replaces": m["replaces"], "launches": row["launches"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "single_ms": row["single_ms"], "bit_equal_per_problem": True})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
