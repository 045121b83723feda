"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch (the repository's
conftest.py imports JAX; skip it there):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: K1 exact; K2 (both entries) equal counts, quaternion within
2e-4 and translation within 2e-3 (same math, float32 sums in another
order); the front end on the card vs on the CPU within 5e-4 / 5e-3 m per
frame. The batched entries (each kernel under torch.func.vmap, one launch
for all problems) equal a launch a problem bit for bit, since every
problem runs the same code in its own blocks or cluster, and meet the
same tolerances against the plain version; multiseq.frame_batch on the
card launches each kernel once a batched frame. The rounding kernels
(csrc/f32ops.cu: sq_dist, sum3_sq, atan2) equal their plain versions bit
for bit, on the card and on the CPU, and vmapped in one launch; so does
odometry's 2-NN sweep (csrc/sweep_top2.cu), in its indices and points. The
Kabsch kernel (csrc/kabsch.cu) within 1e-6 of its plain version on the
same batches (the same IEEE operations in the same order), the segment
sum (csrc/segment_sum.cu) bit for bit. The fused kernels equal their
plain versions bit for bit, on the card and on the CPU: the optimise's
Hessian-vector product (csrc/hess_matvec.cu) at 256 to 8192 nodes, and
ICP's Kabsch step (csrc/kabsch_step.cu) at 2 x 2048 and 1 x 8192 points
(the plain step's square roots are ops/f32.py `sqrt`, correctly rounded
as on the card; the CPU's torch.sqrt misrounds some inputs by an ulp),
vmapped in one launch. The step is also held to a float64 Kabsch at both
stages' shapes (tests/kabsch_reference.py: the quaternion within 1e-5,
the translation within 1e-4 m). Two eager optimises of one graph at each tier
(256 / 64, 1024 / 16, 4096 / 64, 8192 / 256 nodes / loops) are bit-equal
(the loop factors sum in one fixed order). Each program the port captures as a
CUDA graph (scaloam_tpu_torch/compiled.py) replays what it computes
eagerly under compiled.disabled(): bit for bit where two eager calls
agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from scaloam_tpu_torch import config
from scaloam_tpu_torch.models import posegraph as pg
from scaloam_tpu_torch.models.frontend import FrontEnd
from scaloam_tpu_torch.ops import features, se3
from scaloam_tpu_torch.ops.kernels import gn_odometry, selection
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

SEL_KW = dict(n_sub=6, n_corner=20, n_flat=4, curv_thr=0.1)
K2_KW = dict(outer_iterations=2, gn_iterations=4, thr=25.0, huber_delta=0.1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _config():
    cfg = config.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        mapping=dataclasses.replace(cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8,
                                    corner_cell_cap=32, surf_cell_cap=64),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192),
    )


def _scan_inputs(dev):
    world = synthetic.make_world(seed=21)
    pts = synthetic.simulate_scan(world, np.array([0.0, 0.0, 1.8]), 0.4, n_azimuth=250, seed=5)
    si = features.selection_inputs(LidarScan.from_numpy(pts, 16384, dev), _config())
    return si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep


def _tie_inputs(dev, seed=0, S=64, W=2304, n_sub=6, bounds="split"):
    """Quantized curvature (exact ties), random reach and eligibility.
    Subregion bounds: "split" (even), "empty" (every other subregion has
    ep < sp) or "overlap" (random overlapping spans: picks of one round in
    different subregions contend for the same points)."""
    rng = np.random.default_rng(seed)
    L = rng.integers(W // 2, W - 10, size=S)
    j = np.arange(n_sub)
    sp = 5 + (L[:, None] * j) // n_sub
    ep = 5 + (L[:, None] * (j + 1)) // n_sub - 1
    if bounds == "empty":
        ep = np.where(j % 2 == 1, sp - 1 - (j // 2), ep)
    elif bounds == "overlap":
        sp = rng.integers(0, W // 2, size=(S, n_sub))
        ep = sp + rng.integers(W // 8, W // 2, size=(S, n_sub))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return (
        t(rng.integers(0, 8, (S, W)) * 0.05, torch.float32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t((np.arange(W) >= 5) & (np.arange(W) <= 4 + L[:, None]) & (rng.uniform(size=(S, W)) < 0.9), torch.bool),
        t(sp, torch.int32),
        t(ep, torch.int32),
    )


@pytest.mark.parametrize("inputs", ["scan", "ties", "nsub1", "empty", "overlap"])
def test_selection_kernel_matches_plain(dev, inputs):
    kw = dict(SEL_KW, n_sub=1) if inputs == "nsub1" else SEL_KW
    if inputs == "scan":
        args = _scan_inputs(dev)
    else:
        bounds = inputs if inputs in ("empty", "overlap") else "split"
        args = _tie_inputs(dev, n_sub=kw["n_sub"], bounds=bounds)
    before = selection.select_features.launches
    got = selection.select_features(*args, **kw)
    want = selection.select_features_plain(*args, **kw)
    torch.cuda.synchronize()
    assert selection.select_features.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 0 and int(got[3].sum()) > 0


def test_selection_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = _tie_inputs(dev, S=8, W=256)
    curv, left = args[0], args[1]
    for i, bad in ((0, curv.double()), (0, curv.t().contiguous().t()), (1, left.cpu())):
        with pytest.raises(ValueError):
            selection.select_features(*args[:i], bad, *args[i + 1:], **SEL_KW)


def _scenario(dev, seed, n_c=768, n_s=1536):
    """Candidates are ground-truth transformed points plus small
    class-consistent offsets (the reference's tests/test_pallas_gn.py)."""
    rng = np.random.default_rng(seed)
    T = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    gt = Pose(se3.exp_so3(T(rng.normal(0, 0.02, 3))), T(rng.normal(0, 0.3, 3)))
    cx, cm = T(rng.uniform(-20, 20, (n_c, 3))), T(rng.uniform(size=n_c) < 0.8, torch.bool)
    sx, sm = T(rng.uniform(-20, 20, (n_s, 3))), T(rng.uniform(size=n_s) < 0.8, torch.bool)
    cw, sw = se3.apply(gt, cx), se3.apply(gt, sx)
    cand = lambda base, s: base[:, None] + T(rng.normal(0, s, (base.shape[0], 2, 3)))
    return (cx, cand(cw, 0.05), cand(cw, 0.3), cm, sx, cand(sw, 0.05), cand(sw, 0.2),
            cand(sw, 0.3), sm)


@pytest.mark.parametrize("case", ["seed0", "seed3", "all_invalid"])
def test_gn_kernel_matches_plain(dev, case):
    if case == "all_invalid":
        arrs = list(_scenario(dev, 1, 64, 128))
        arrs[3] = torch.zeros_like(arrs[3])
        arrs[8] = torch.zeros_like(arrs[8])
    else:
        arrs = _scenario(dev, int(case[-1]))
    q0 = torch.tensor([1.0, 0, 0, 0], device=dev)
    t0 = torch.tensor([0.5, -0.25, 1.0], device=dev)
    before = gn_odometry.associate_and_solve.launches
    q, t, n_c, n_s = gn_odometry.associate_and_solve(*arrs, q0, t0, **K2_KW)
    wq, wt, wn_c, wn_s = gn_odometry.associate_and_solve_plain(*arrs, q0, t0, **K2_KW)
    torch.cuda.synchronize()
    assert gn_odometry.associate_and_solve.launches == before + 1
    assert (int(n_c), int(n_s)) == (int(wn_c), int(wn_s))
    if torch.dot(q, wq) < 0:
        q = -q
    assert float((q - wq).abs().max()) <= 2e-4
    assert float((t - wt).abs().max()) <= 2e-3
    if case == "all_invalid":
        assert (int(n_c), int(n_s)) == (0, 0)
        assert float((t - t0).abs().max()) <= 1e-5


def test_frontend_on_card_tracks_plain_versions_on_cpu(dev):
    cfg = _config()
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=8), n_frames=3, speed=0.8, radius=25.0,
        n_azimuth=256, seed=3)
    gpu, cpu = FrontEnd(cfg, device=dev), FrontEnd(cfg, device="cpu")
    k1, k2 = selection.select_features.launches, gn_odometry.associate_and_solve.launches
    k2b = gn_odometry.gn_solve_prepared.launches
    for s in scans:
        g = gpu.step(*LidarScan.from_numpy(s, cfg.sensor.max_points, dev))
        c = cpu.step(*LidarScan.from_numpy(s, cfg.sensor.max_points, "cpu"))
        assert bool(g.fire) == bool(c.fire)
        for a, b in ((g.odom_world, c.odom_world), (g.mapped_pose, c.mapped_pose)):
            qa, qb = a.quat.cpu(), b.quat
            if torch.dot(qa, qb) < 0:
                qa = -qa
            assert float((qa - qb).abs().max()) <= 5e-4
            assert float((a.trans.cpu() - b.trans).abs().max()) <= 5e-3
    assert selection.select_features.launches == k1 + len(scans)
    assert gn_odometry.associate_and_solve.launches == k2 + len(scans) - 1
    # mapping runs both outer passes every frame, one entry-B launch each
    assert gn_odometry.gn_solve_prepared.launches == k2b + 2 * len(scans)


def _prepared(dev, seed, n_c=2048, n_s=6656, frac_valid=0.8):
    """Mapping-sized prepared factors around a ground-truth pose; invalid
    rows hold NaN, as mapping's degenerate fits do."""
    rng = np.random.default_rng(seed)
    T = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    gt = Pose(se3.exp_so3(T(rng.normal(0, 0.02, 3))), T(rng.normal(0, 0.3, 3)))
    cp, sp = T(rng.uniform(-20, 20, (n_c, 3))), T(rng.uniform(-20, 20, (n_s, 3)))
    cw, sw = se3.apply(gt, cp), se3.apply(gt, sp)
    u = torch.nn.functional.normalize(T(rng.normal(size=(n_c, 3))), dim=1)
    ca = cw + 0.1 * u + T(rng.normal(0, 0.01, (n_c, 3)))
    cb = cw - 0.1 * u + T(rng.normal(0, 0.01, (n_c, 3)))
    sn = torch.nn.functional.normalize(T(rng.normal(size=(n_s, 3))), dim=1)
    sd = -(sn * sw).sum(1) + T(rng.normal(0, 0.01, n_s))
    cv = T(rng.uniform(size=n_c) < frac_valid, torch.bool)
    sv = T(rng.uniform(size=n_s) < frac_valid, torch.bool)
    ca[~cv] = float("nan")
    sn[~sv] = float("nan")
    sd[~sv] = float("nan")
    return cp, ca, cb, cv, sp, sn, sd, sv


@pytest.mark.parametrize("case", ["seed0", "seed4", "all_invalid"])
def test_gn_prepared_kernel_matches_plain(dev, case):
    arrs = _prepared(dev, 1 if case == "all_invalid" else int(case[-1]),
                     frac_valid=0.0 if case == "all_invalid" else 0.8)
    q0 = torch.tensor([1.0, 0, 0, 0], device=dev)
    t0 = torch.tensor([0.5, -0.25, 1.0], device=dev)
    kw = dict(gn_iterations=4, huber_delta=0.1)
    before = gn_odometry.gn_solve_prepared.launches
    q, t = gn_odometry.gn_solve_prepared(q0, t0, *arrs, **kw)
    wq, wt = gn_odometry.gn_solve_prepared_plain(q0, t0, *arrs, **kw)
    torch.cuda.synchronize()
    assert gn_odometry.gn_solve_prepared.launches == before + 1
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(t).all())
    if torch.dot(q, wq) < 0:
        q = -q
    assert float((q - wq).abs().max()) <= 2e-4
    assert float((t - wt).abs().max()) <= 2e-3
    if case == "all_invalid":
        assert float((t - t0).abs().max()) <= 1e-5


def test_gn_cluster_size_is_portable_at_main_path_sizes(dev):
    cfg = config.kitti_hdl64()
    odo = gn_odometry.cluster_size(cfg.features.max_sharp, cfg.features.max_flat, prepared=False)
    mapping = gn_odometry.cluster_size(cfg.mapping.max_corner_input, cfg.mapping.max_surf_input,
                                       prepared=True)
    assert 1 <= odo <= 8 and 1 <= mapping <= 8
    with pytest.raises(ValueError):  # too many points for 8 blocks' shared memory
        gn_odometry.cluster_size(40000, 40000, prepared=True)


# ---------------------------------------------------------------------------
# the batched entries: torch.func.vmap over problems, one launch a call
# ---------------------------------------------------------------------------


def _stack(problems):
    return [torch.stack(a) for a in zip(*problems)]


def test_batched_selection_matches_per_problem_and_plain(dev):
    """Three frames in one launch over 3 x 64 rows: bit-equal to a launch a
    frame and to the plain version."""
    args = _stack([_tie_inputs(dev, seed=s, bounds=b)
                   for s, b in ((0, "split"), (1, "overlap"), (2, "empty"))])
    before = selection.select_features.launches
    got = torch.func.vmap(lambda *a: selection.select_features(*a, **SEL_KW))(*args)
    torch.cuda.synchronize()
    assert selection.select_features.launches == before + 1
    for b in range(3):
        one = selection.select_features(*(a[b] for a in args), **SEL_KW)
        plain = selection.select_features_plain(*(a[b] for a in args), **SEL_KW)
        for g, o, p in zip(got, one, plain):
            assert torch.equal(g[b], o) and torch.equal(g[b], p)


def test_batched_gn_kernel_matches_per_problem_and_plain(dev):
    """Entry A over three problems, the initial pose shared (not batched):
    one launch of three clusters, each bit-equal to its own launch and
    within the K2 tolerances of the plain version."""
    arrs = _stack([_scenario(dev, s) for s in (0, 3, 5)])
    q0 = torch.tensor([1.0, 0, 0, 0], device=dev)
    t0 = torch.tensor([0.5, -0.25, 1.0], device=dev)
    before = gn_odometry.associate_and_solve.launches
    got = torch.func.vmap(lambda *a: gn_odometry.associate_and_solve(*a, **K2_KW),
                          in_dims=(0,) * 9 + (None, None))(*arrs, q0, t0)
    torch.cuda.synchronize()
    assert gn_odometry.associate_and_solve.launches == before + 1
    for b in range(3):
        one = gn_odometry.associate_and_solve(*(a[b] for a in arrs), q0, t0, **K2_KW)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
        wq, wt, wn_c, wn_s = gn_odometry.associate_and_solve_plain(
            *(a[b] for a in arrs), q0, t0, **K2_KW)
        q, t = got[0][b], got[1][b]
        assert (int(got[2][b]), int(got[3][b])) == (int(wn_c), int(wn_s))
        if torch.dot(q, wq) < 0:
            q = -q
        assert float((q - wq).abs().max()) <= 2e-4
        assert float((t - wt).abs().max()) <= 2e-3


def test_batched_gn_prepared_matches_per_problem_and_plain(dev):
    """Entry B over three problems (one all-invalid) from three poses: one
    launch, each problem bit-equal to its own launch, within the K2
    tolerances of the plain version."""
    arrs = _stack([_prepared(dev, s, frac_valid=f) for s, f in ((0, 0.8), (4, 0.8), (1, 0.0))])
    q0 = torch.tensor([[1.0, 0, 0, 0]] * 3, device=dev)
    t0 = torch.tensor([[0.5, -0.25, 1.0], [0.0, 0.0, 0.0], [0.1, 0.2, 0.3]], device=dev)
    kw = dict(gn_iterations=4, huber_delta=0.1)
    before = gn_odometry.gn_solve_prepared.launches
    got = torch.func.vmap(lambda *a: gn_odometry.gn_solve_prepared(*a, **kw))(q0, t0, *arrs)
    torch.cuda.synchronize()
    assert gn_odometry.gn_solve_prepared.launches == before + 1
    for b in range(3):
        one = gn_odometry.gn_solve_prepared(q0[b], t0[b], *(a[b] for a in arrs), **kw)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])
        wq, wt = gn_odometry.gn_solve_prepared_plain(q0[b], t0[b], *(a[b] for a in arrs), **kw)
        q = got[0][b] if torch.dot(got[0][b], wq) >= 0 else -got[0][b]
        assert float((q - wq).abs().max()) <= 2e-4
        assert float((got[1][b] - wt).abs().max()) <= 2e-3
    assert float((got[1][2] - t0[2]).abs().max()) <= 1e-5  # all invalid: the pose holds


def test_frame_batch_on_card_tracks_cpu_with_one_launch_each(dev):
    """multiseq.frame_batch over two sequences on the card: one launch of
    K1, K2 A (from the second frame) and outer_iterations of K2 B a
    batched frame, two of the odometry's sweep (from the second frame) and
    none of sq_dist; poses within 5e-4 / 5e-3 m of the same batch on the
    CPU."""
    from scaloam_tpu_torch.ops.kernels import f32ops, sweep_top2
    from scaloam_tpu_torch.parallel import multiseq

    cfg = _config()
    world = synthetic.make_world(seed=8)
    seqs = [synthetic.simulate_trajectory(world, n_frames=2, speed=0.8 + 0.2 * s, radius=25.0,
                                          n_azimuth=256, seed=3 + s)[0] for s in range(2)]
    states = {d: multiseq.init_states(2, cfg, d) for d in (dev, "cpu")}
    for f in range(2):
        poses = {}
        for d in (dev, "cpu"):
            scans = [LidarScan.from_numpy(seqs[s][f], cfg.sensor.max_points, d) for s in range(2)]
            counters = (selection.select_features, gn_odometry.associate_and_solve,
                        gn_odometry.gn_solve_prepared, sweep_top2.sweep_top2, f32ops.sq_dist)
            counts = [c.launches for c in counters]
            o, m, odom, mapped = multiseq.frame_batch(
                *states[d], torch.stack([s.xyz for s in scans]),
                torch.stack([s.mask for s in scans]), cfg)
            states[d] = (o, m)
            poses[str(d)] = (odom, mapped)
            if d == dev:
                torch.cuda.synchronize()
                assert tuple(c.launches - n for c, n in zip(counters, counts)) == (
                    1, int(f > 0), cfg.mapping.outer_iterations, 2 * int(f > 0), 0)
        for a, b in zip(poses[str(dev)], poses["cpu"]):
            qa = a.quat.cpu()
            qa = torch.where((qa * b.quat).sum(-1, keepdim=True) < 0, -qa, qa)
            assert float((qa - b.quat).abs().max()) <= 5e-4
            assert float((a.trans.cpu() - b.trans).abs().max()) <= 5e-3


def _rounding_inputs(dev, seed):
    """Points at a scan's ranges, integer points (exact ties) and
    quadrant / axis / signed-zero pairs for atan2."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    pts = T(rng.uniform(-60, 60, (2, 1000, 3)))
    ints = T(rng.integers(-6, 7, (2, 1000, 3)))
    yx = T(rng.uniform(-100, 100, (2, 5000)))
    yx[0, :64], yx[1, 64:128], yx[0, 128:192] = 0.0, 0.0, -0.0
    yx[0, 192:256] *= 1e-4
    return pts, ints, yx


@pytest.mark.parametrize("seed", [0, 1])
def test_rounding_kernels_match_plain_bit_for_bit(dev, seed):
    """csrc/f32ops.cu's sq_dist, sum3_sq and atan2 equal their plain
    versions (ops/f32.py) bit for bit, on the card and on the CPU."""
    from scaloam_tpu_torch.ops import f32
    from scaloam_tpu_torch.ops.kernels import f32ops

    pts, ints, yx = _rounding_inputs(dev, seed)
    for p in (pts, ints):
        got = f32ops.sq_dist(p[0, :300], p[1])
        for want in (f32.sq_dist(p[0, :300], p[1]), f32.sq_dist(p[0, :300].cpu(), p[1].cpu())):
            assert torch.equal(got.cpu().view(torch.int32), want.cpu().view(torch.int32))
        got = f32ops.sum3_sq(p - p[:, :1])
        assert torch.equal(got.view(torch.int32), f32.sum3_sq(p - p[:, :1]).view(torch.int32))
    got = f32ops.atan2(yx[0], yx[1])
    for want in (f32.atan2(yx[0], yx[1]), f32.atan2(yx[0].cpu(), yx[1].cpu())):
        assert torch.equal(got.cpu().view(torch.int32), want.cpu().view(torch.int32))


def test_rounding_kernels_fold_a_vmapped_batch_into_one_launch(dev):
    """Under torch.func.vmap each rounding kernel launches once for the
    batch, equal to a launch a problem; an unbatched argument is expanded."""
    from scaloam_tpu_torch.ops.kernels import f32ops

    pts, ints, yx = _rounding_inputs(dev, 2)
    calls = ((f32ops.sq_dist, (pts, ints), (0, 0)), (f32ops.sq_dist, (pts, ints[0]), (0, None)),
             (f32ops.sum3_sq, (pts,), (0,)), (f32ops.atan2, (yx, yx[1]), (0, None)))
    for fn, args, dims in calls:
        before = fn.launches
        got = torch.func.vmap(fn, in_dims=dims)(*args)
        assert fn.launches - before == 1
        for b in range(2):
            one = fn(*(a[b] if d == 0 else a for a, d in zip(args, dims)))
            assert torch.equal(got[b], one)


# ---------------------------------------------------------------------------
# odometry's 2-NN sweep (csrc/sweep_top2.cu): one launch a sweep
# ---------------------------------------------------------------------------


def _sweep_args(dev, name, seed=0):
    """A case of tests/sweep_cases.py on the card: (query, target, mask,
    ring), nearby and the tiles as the odometry asks for them."""
    from sweep_cases import sweep_case

    c = sweep_case(name, seed)
    args = [torch.tensor(c[k], device=dev) for k in ("query", "target", "mask", "ring")]
    return args, c["nearby"], c["tile_any"], c["tile_ring"]


def _sweep_equal(got, want):
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu().view(torch.int32), want[1].cpu().view(torch.int32))


@pytest.mark.parametrize("want_same", [True, False])
@pytest.mark.parametrize("name", ["surf", "corner", "odd", "ties", "masked_tiles", "empty"])
def test_sweep_top2_kernel_matches_plain(dev, name, want_same):
    """The sweep kernel equals its plain version (the former composition:
    sq_dist blocks, masks, tile_top2, merge_top2) bit for bit in the
    indices and the points gathered, on the card and, at the small shapes,
    on the CPU; one launch a call. The shapes: the less-flat and less-sharp
    sweeps at the presets' capacities, a cloud no multiple of 8192, and the
    tie, tile-mask and empty cases."""
    from sweep_cases import SMALL
    from scaloam_tpu_torch.ops import voxel
    from scaloam_tpu_torch.ops.kernels import sweep_top2

    args, nearby, tile_any, tile_ring = _sweep_args(dev, name)
    T = args[1].shape[0]
    tiles = (voxel.fit_tile(T, tile_any), voxel.fit_tile(T, tile_ring))
    before = sweep_top2.sweep_top2.launches
    got = sweep_top2.sweep_top2(*args, nearby, want_same, tile_any, tile_ring)
    torch.cuda.synchronize()
    assert sweep_top2.sweep_top2.launches == before + 1
    _sweep_equal(got, sweep_top2.sweep_top2_plain(*args, nearby, want_same, *tiles))
    if name in SMALL:
        cpu = sweep_top2.sweep_top2_plain(*(a.cpu() for a in args), nearby, want_same, *tiles)
        _sweep_equal(got, cpu)
    if name == "empty":
        assert bool((got[0] == -1).all()) and not bool(got[1].any())


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("name", ["odd", "ties", "masked_tiles"])
def test_sweep_top2_kernel_matches_plain_at_every_lane_count(dev, monkeypatch, name, lanes):
    """Each split of a query's targets over lanes (the kernel picks one
    from the problem count) merges the lanes' winners to the plain
    version's, bit for bit."""
    from scaloam_tpu_torch.ops import voxel
    from scaloam_tpu_torch.ops.kernels import sweep_top2

    monkeypatch.setattr(sweep_top2, "_lanes", lambda problems, device: lanes)
    args, nearby, tile_any, tile_ring = _sweep_args(dev, name, seed=lanes)
    T = args[1].shape[0]
    tiles = (voxel.fit_tile(T, tile_any), voxel.fit_tile(T, tile_ring))
    for want_same in (True, False):
        got = sweep_top2.sweep_top2(*args, nearby, want_same, tile_any, tile_ring)
        _sweep_equal(got, sweep_top2.sweep_top2_plain(*args, nearby, want_same, *tiles))


@pytest.mark.parametrize("name", ["surf", "corner"])
def test_sweep_top2_folds_a_vmapped_batch_into_one_launch(dev, name):
    """Under torch.func.vmap at B = 8 (the fleet's sequences) the sweep
    launches once, equal to a launch a problem and to the plain version."""
    from scaloam_tpu_torch.ops import voxel
    from scaloam_tpu_torch.ops.kernels import sweep_top2

    parts = [_sweep_args(dev, name, seed=s) for s in range(8)]
    args = [torch.stack(a) for a in zip(*(p[0] for p in parts))]
    _, nearby, tile_any, tile_ring = parts[0]
    want_same = name == "surf"
    before = sweep_top2.sweep_top2.launches
    got = torch.func.vmap(lambda *a: sweep_top2.sweep_top2(
        *a, nearby, want_same, tile_any, tile_ring))(*args)
    torch.cuda.synchronize()
    assert sweep_top2.sweep_top2.launches == before + 1
    T = args[1].shape[1]
    tiles = (voxel.fit_tile(T, tile_any), voxel.fit_tile(T, tile_ring))
    for b in range(8):
        one = sweep_top2.sweep_top2(*(a[b] for a in args), nearby, want_same, tile_any,
                                    tile_ring)
        _sweep_equal((got[0][b], got[1][b]), one)
        _sweep_equal(one, sweep_top2.sweep_top2_plain(*(a[b] for a in args), nearby,
                                                      want_same, *tiles))


# ---------------------------------------------------------------------------
# the keyframe backend's kernels: Kabsch rotation, fixed-order segment sum
# ---------------------------------------------------------------------------


def test_kabsch_kernel_matches_plain(dev):
    """Random, near-planar, reflected, rank-2 and zero H (chip_smoke's cases)."""
    import chip_smoke
    from scaloam_tpu_torch.ops.kernels import kabsch

    H = torch.cat(list(chip_smoke.kabsch_cases(torch, dev).values()))
    before = kabsch.kabsch_rotation.launches
    got = kabsch.kabsch_rotation(H)
    assert kabsch.kabsch_rotation.launches == before + 1
    plain = kabsch.kabsch_plain(H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= 1e-6
    eye = torch.eye(3, device=dev)
    assert float((got @ got.mT - eye).abs().max()) < 1e-5
    assert torch.equal(got[-8:], eye.expand(8, 3, 3))  # H = 0
    batched = torch.func.vmap(kabsch.kabsch_rotation)(H.reshape(2, -1, 3, 3))
    assert torch.equal(batched.reshape(-1, 3, 3), got)


def test_segment_sum_kernel_matches_plain(dev):
    from scaloam_tpu_torch.ops.kernels import segment_sum

    rng = np.random.default_rng(1)
    for n, R, c in ((64, 300, 6), (4096, 512, 36), (10, 0, 6)):
        idx = torch.from_numpy(rng.integers(0, n, R) if n > 10 else np.zeros(R, np.int64))
        base = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        rows = torch.from_numpy((rng.normal(size=(R, c)) * 10.0 ** rng.integers(-3, 4, (R, 1)))
                                .astype(np.float32))
        plan_cpu = segment_sum.plan(idx, n)
        want = segment_sum.add(base, rows, plan_cpu)
        plan = segment_sum.plan(idx.to(dev), n)
        before = segment_sum.add.launches
        got = segment_sum.add(base.to(dev), rows.to(dev), plan)
        assert segment_sum.add.launches == before + (1 if n * c else 0)
        plain = segment_sum.add_plain(base.to(dev), rows.to(dev), *plan)
        assert torch.equal(got, plain) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("nodes,loops,lap", [(256, 64, 64), (1024, 16, 512), (4096, 64, 512),
                                             (8192, 256, 512)])
def test_eager_optimise_is_reproducible(dev, nodes, loops, lap):
    """Two eager optimises of one graph give the same poses bit for bit at
    every tier: the loop factors reach their nodes in one fixed order (no
    atomics). The 256-node chain laps a 64-node circle, so it has loops."""
    import chip_smoke
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.types import Pose

    _, oq, ot, lps = chip_smoke.circle_chain(nodes, loops, seed=nodes, lap=lap)
    assert len(lps) == loops
    cfg = chip_smoke.chain_pgo_cfg(config.PGOConfig(), nodes, loops)
    with compiled.disabled():
        runs = [pg.optimize(chip_smoke.build_graph(torch, pg, Pose, cfg, oq, ot, lps, dev), cfg)
                for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(pytree.tree_leaves(runs[0]), pytree.tree_leaves(runs[1])):
        assert torch.equal(chip_smoke._bits(torch, a), chip_smoke._bits(torch, b))


# ---------------------------------------------------------------------------
# the fused kernels: the optimise's Hessian-vector product, ICP's Kabsch step
# ---------------------------------------------------------------------------


def _mv_inputs(dev, N, n, L, n_loops, seed):
    """The matvec's inputs at capacity N (n nodes, the rest padding) with
    n_loops loops of capacity L whose ends share nodes, node 0 and every
    seventh node frozen."""
    from scaloam_tpu_torch import config as tconfig

    rng = np.random.default_rng(seed)
    cfg = tconfig.PGOConfig(max_keyframes=N, max_loops=L, loop_variance=1e-3)
    g = pg.init_graph(cfg, dev, initial_nodes=N, initial_loops=L)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    for k in range(n):
        t = torch.tensor([float(k), 0.05 * k * rng.standard_normal(), 0.0], device=dev)
        g = pg.add_keyframe(g, Pose(ident, t), float(k % 3), k % 5 == 0, n_nodes=k)
    for m in range(n_loops):
        i, j = n - 1 - m % 4, (7 * m) % max(1, n // 2)
        z = Pose(ident, torch.tensor([float(j - i), 0.3, 0.0], device=dev))
        g = pg.add_loop(g, i, j, z, n_loops=m)
    factors = [pg._sanitize(f) for f in pg._linearize(g, cfg)]
    plans = pg.loop_plans(g)
    _, D, D_loop = pg._gradient_and_diag(factors, N, plans)
    damp = pg._damping(D, D_loop, cfg.lm_damping)
    ks = torch.arange(N, device=dev)
    free = (ks > 0) & (ks < n) & (ks % 7 != 0)
    v = torch.from_numpy(rng.normal(size=(N, 6)).astype(np.float32)).to(dev)
    return factors, plans, v, damp, free


def _int_bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("N,n,L,n_loops", [
    (256, 219, 64, 40), (1024, 1024, 16, 16), (4096, 4001, 64, 64), (8192, 8192, 256, 256),
    (256, 200, 64, 0), (100, 37, 8, 8)])
def test_hess_matvec_kernel_matches_plain(dev, N, n, L, n_loops):
    """Bit for bit at the optimise's tiers, with padding and frozen nodes,
    loops sharing nodes, no loops, and node counts that end mid-block."""
    from scaloam_tpu_torch.ops.kernels import hess_matvec

    factors, plans, v, damp, free = _mv_inputs(dev, N, n, L, n_loops, seed=N + n_loops)
    odom, loops, gps = factors
    got = {}
    for mask in (free, torch.ones_like(free)):
        before = hess_matvec.hess_matvec.launches
        got[mask.all().item()] = out = hess_matvec.hess_matvec(odom, gps, loops, plans, v, damp,
                                                              mask)
        assert hess_matvec.hess_matvec.launches == before + 1
        want = hess_matvec.hess_matvec_plain(
            *hess_matvec.operands(odom, gps, loops, plans, v, damp, mask))
        torch.cuda.synchronize()
        assert torch.equal(_int_bits(out), _int_bits(want))
        assert torch.isfinite(out).all() and torch.all(out[~mask] == 0)
    # the product on the CPU (the plain version there: multiplies, adds and
    # selects only) gives the same bits
    cpu = [t.cpu() for t in (v, damp, free)]
    cpu_factors = [f._replace(**{k: x.cpu() for k, x in f._asdict().items()}) for f in factors]
    cpu_plans = tuple(type(p)(*(x.cpu() for x in p)) for p in plans)
    on_cpu = pg._hess_matvec(cpu_factors, cpu[0], cpu[1], cpu_plans, cpu[2])
    assert torch.equal(_int_bits(on_cpu), _int_bits(got[False].cpu()))


def _step_inputs(dev, B, S, seed, keep=0.7):
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(S, 3)) * 10).astype(np.float32)
    tgt = np.stack([src + rng.normal(size=3) + rng.normal(size=(S, 3)) * 0.05 for _ in range(B)])
    w = (rng.uniform(size=(B, S)) < keep).astype(np.float32)
    return (torch.from_numpy(src).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(tgt.astype(np.float32)).to(dev))


@pytest.mark.parametrize("B,S,mask_q,keep", [
    (2, 2048, False, 0.7), (1, 8192, True, 0.7), (2, 1000, True, 0.5), (1, 100, False, 0.9),
    (2, 2048, True, 0.0), (1, 8192, False, 0.01)])
def test_kabsch_step_kernel_matches_plain(dev, B, S, mask_q, keep):
    """Bit for bit at both ICP stages' shapes (2 x 2048 coarse, 1 x 8192
    fine), a point count no multiple of the threads, one block a row, all
    weights zero and nearly all zero; the rotation equals kabsch_rotation
    on the plain step's H."""
    from scaloam_tpu_torch.ops.kernels import kabsch

    src, w, tgt = _step_inputs(dev, B, S, seed=S + B, keep=keep)
    before = kabsch.kabsch_step.launches
    got = kabsch.kabsch_step(src, w, tgt, mask_q)
    assert kabsch.kabsch_step.launches == before + 1
    want_q, want_t = kabsch.kabsch_step_plain(src[None], w, tgt, mask_q)
    torch.cuda.synchronize()
    assert torch.equal(_int_bits(got.quat), _int_bits(want_q))
    assert torch.equal(_int_bits(got.trans), _int_bits(want_t))
    _, _, H = kabsch.kabsch_step_parts(src[None], w, tgt, mask_q)
    assert torch.equal(_int_bits(kabsch.kabsch_rotation(H)), _int_bits(kabsch.kabsch_plain(H)))
    # the plain step on the CPU (correctly rounded square roots) gives the same bits
    cpu_q, cpu_t = kabsch.kabsch_step_plain(src[None].cpu(), w.cpu(), tgt.cpu(), mask_q)
    assert torch.equal(_int_bits(got.quat.cpu()), _int_bits(cpu_q))
    assert torch.equal(_int_bits(got.trans.cpu()), _int_bits(cpu_t))
    if keep == 0.0:
        assert torch.equal(got.quat, torch.tensor([[1.0, 0, 0, 0]] * B, device=dev))


@pytest.mark.parametrize("B,S,mask_q", [(2, 2048, False), (1, 8192, True), (2, 2048, True)])
def test_kabsch_step_kernel_matches_float64(dev, B, S, mask_q):
    """At both ICP stages' shapes (2 x 2048 coarse, 1 x 8192 fine) the
    kernel's pose is the float64 Kabsch's within the tolerances of the CPU
    tests (tests/kabsch_reference.py), on clouds of ~10 m turned by up to
    0.1 rad, a fifth of the weights zero."""
    from kabsch_reference import F64_Q_TOL, F64_T_TOL, f64_kabsch, quat_err
    from scaloam_tpu_torch.ops.kernels import kabsch

    rng = np.random.default_rng(S + B + mask_q)
    src = (rng.normal(size=(S, 3)) * 10).astype(np.float32)
    tgt = []
    for b in range(B):
        axis = rng.normal(size=3)
        axis *= 0.05 * (b + 1) / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        th = np.linalg.norm(axis)
        R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K
        tgt.append(src @ R.T + rng.normal(size=3) + rng.normal(size=(S, 3)) * 0.01)
    tgt = np.stack(tgt).astype(np.float32)
    w = (rng.uniform(size=(B, S)) < 0.8).astype(np.float32)
    got = kabsch.kabsch_step(torch.from_numpy(src).to(dev), torch.from_numpy(w).to(dev),
                             torch.from_numpy(tgt).to(dev), mask_q)
    quat, trans = got.quat.cpu().numpy(), got.trans.cpu().numpy()
    for b in range(B):
        R, t = f64_kabsch(src, w[b], tgt[b], mask_q)
        want_q = se3.mat_to_quat(torch.from_numpy(R)).numpy()
        assert quat_err(quat[b], want_q) <= F64_Q_TOL
        assert np.abs(trans[b] - t).max() <= F64_T_TOL


def test_kabsch_step_folds_a_vmapped_batch_into_one_launch(dev):
    from scaloam_tpu_torch.ops.kernels import kabsch

    V = 3
    parts = [_step_inputs(dev, 2, 2048, seed=40 + i) for i in range(V)]
    src, w, tgt = (torch.stack(x) for x in zip(*parts))
    before = kabsch.kabsch_step.launches
    out = torch.func.vmap(lambda s, ww, t: kabsch.kabsch_step(s, ww, t, False))(src, w, tgt)
    assert kabsch.kabsch_step.launches == before + 1
    for i in range(V):
        one = kabsch.kabsch_step(src[i], w[i], tgt[i], False)
        assert torch.equal(out.quat[i], one.quat) and torch.equal(out.trans[i], one.trans)


# ---------------------------------------------------------------------------
# the front end's ring id and azimuth pass, the optimise's chain solve
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    return a.dtype == b.dtype and (torch.equal(a.view(torch.int32), b.view(torch.int32))
                                   if a.is_floating_point() else torch.equal(a, b))


def _ring_points(lidar, seed):
    """A synthetic frame of the sensor, points on its ring bounds, random
    points at every angle and the origin."""
    import chip_smoke

    n_scans = chip_smoke.RING_BOUNDS[lidar][0]
    pts = synthetic.simulate_scan(synthetic.make_world(seed), np.array([0.3, -0.2, 1.7]), 0.3,
                                  n_scans=n_scans, n_azimuth=512, lidar_type=lidar, seed=seed)
    rand = np.random.default_rng(seed).uniform(-100, 100, (4096, 3))
    return torch.from_numpy(np.concatenate([
        pts, chip_smoke.ring_bound_points(lidar, seed), rand, np.zeros((4, 3))]).astype(
            np.float32)), n_scans


@pytest.mark.parametrize("lidar", ["VLP16", "HDL32", "HDL64", "OS1-64"])
def test_ring_azimuth_kernel_matches_plain(dev, lidar):
    """Bit for bit against the plain version on the card and on the CPU,
    one launch a call."""
    from scaloam_tpu_torch.ops.kernels import ring_azimuth

    pts, n_scans = _ring_points(lidar, 3)
    before = ring_azimuth.ring_azimuth.launches
    got = ring_azimuth.ring_azimuth(pts.to(dev), lidar, n_scans)
    assert ring_azimuth.ring_azimuth.launches == before + 1
    for want in (ring_azimuth.ring_azimuth_plain(pts.to(dev), lidar, n_scans),
                 ring_azimuth.ring_azimuth_plain(pts, lidar, n_scans)):
        assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert got[1].any() and not got[1].all()


def test_ring_azimuth_folds_a_vmapped_batch_into_one_launch(dev):
    from scaloam_tpu_torch.ops.kernels import ring_azimuth

    batch = torch.stack([_ring_points("OS1-64", s)[0][:20000] for s in range(8)]).to(dev)
    before = ring_azimuth.ring_azimuth.launches
    got = torch.func.vmap(lambda p: ring_azimuth.ring_azimuth(p, "OS1-64", 64))(batch)
    assert ring_azimuth.ring_azimuth.launches == before + 1
    for b in range(8):
        one = ring_azimuth.ring_azimuth(batch[b], "OS1-64", 64)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))


def test_card_sqrt_is_the_float64_root_rounded_once(dev):
    """ring_azimuth's __fsqrt_rn (sqrt.rn.f32, as torch.sqrt on the card)
    against ops/f32.py's sqrt (the float64 root rounded once, the plain
    version's), over positive float32 values of every exponent."""
    from scaloam_tpu_torch.ops import f32

    bits = torch.randint(0x00800000, 0x7F7FFFFF, (1 << 20,), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int64).to(torch.int32)
    x = bits.view(torch.float32)
    got = torch.sqrt(x.to(dev))
    assert _same_bits(got, f32.sqrt(x.to(dev))) and _same_bits(got, f32.sqrt(x))


def _solve_chain(n, seed, reg=1e-5):
    """The factor of a random SPD chain of n blocks (on the CPU)."""
    from scaloam_tpu_torch.ops import blocktri

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    D = np.einsum("nij,nkj->nik", A, A) + 6.0 * np.eye(6, dtype=np.float32)
    B = 0.4 * rng.normal(size=(n, 6, 6)).astype(np.float32)
    return blocktri.factor(torch.from_numpy(D), torch.from_numpy(B), reg=reg)


@pytest.mark.parametrize("n,C", [(1, None), (13, None), (256, None), (100, 40), (300, 5),
                                 (1000, None), (1024, 96), (4096, None), (4096, 384),
                                 (8192, None), (9000, None)])
def test_chain_solve_kernel_matches_plain(dev, n, C):
    """Bit for bit against the plain version on the card and on the CPU,
    unmasked, masked on the way in, and on both sides; one launch a call.
    Up to 256 nodes one block a group of 32 columns stages the factor (40
    columns: a second, ragged group); beyond, a cluster of 8 blocks a group
    spreads the state (9000 nodes pad to 16384)."""
    from scaloam_tpu_torch.ops.kernels import chain_solve

    chain = _solve_chain(n, n)
    rng = np.random.default_rng(n + 1)
    b = torch.from_numpy(rng.normal(size=(n, 6) if C is None else (n, 6, C)).astype(np.float32))
    free = torch.from_numpy(rng.uniform(size=n) > 0.2)
    on_card = type(chain)(*(t.to(dev) for t in chain))
    for fr, mask_out in ((None, False), (free, False), (free, True)):
        before = chain_solve.chain_solve.launches
        got = chain_solve.chain_solve(on_card, b.to(dev), None if fr is None else fr.to(dev),
                                      mask_out)
        assert chain_solve.chain_solve.launches == before + 1
        vec = b.dim() == 2
        for ch, bb, ff in ((on_card, b.to(dev), None if fr is None else fr.to(dev)),
                           (chain, b, fr)):
            want = chain_solve.chain_solve_plain(*ch, bb[..., None] if vec else bb, ff, mask_out)
            assert _same_bits(got, want[..., 0] if vec else want)


def _block_thomas(D, B, b):
    """float64 block-tridiagonal solve: H[i, i] = D[i], H[i, i + 1] = B[i]."""
    n = D.shape[0]
    Dp, bp = D.copy(), b.copy()
    for i in range(1, n):
        M = B[i - 1].T @ np.linalg.inv(Dp[i - 1])
        Dp[i] = D[i] - M @ B[i - 1]
        bp[i] = b[i] - M @ bp[i - 1]
    x = np.zeros_like(b)
    x[-1] = np.linalg.solve(Dp[-1], bp[-1])
    for i in range(n - 2, -1, -1):
        x[i] = np.linalg.solve(Dp[i], bp[i] - B[i] @ x[i + 1])
    return x


@pytest.mark.parametrize("nodes,loops,lap,tol", [(256, 64, 64, 1e-4), (1024, 16, 512, 1e-3)])
def test_chain_solve_on_optimise_chains_matches_float64(dev, nodes, loops, lap, tol):
    """The chain-CG preconditioner's system of (a)'s drifted circle chains
    (odometry variances 1e-6 rotation / 1e-4 translation: diagonal blocks
    up to ~2e6), factored without the per-level floor, against a float64
    block-tridiagonal solve: within tol of the largest entry (float32
    cyclic reduction; the error grows with the chain's length), and
    equal to the plain version on the CPU bit for bit."""
    import chip_smoke
    from scaloam_tpu_torch.ops import blocktri
    from scaloam_tpu_torch.ops.kernels import chain_solve

    _, oq, ot, lps = chip_smoke.circle_chain(nodes, loops, seed=nodes, lap=lap)
    cfg = chip_smoke.chain_pgo_cfg(config.PGOConfig(), nodes, loops)
    g = chip_smoke.build_graph(torch, pg, Pose, cfg, oq, ot, lps, dev)
    factors = [pg._sanitize(f) for f in pg._linearize(g, cfg)]
    _, D, D_loop = pg._gradient_and_diag(factors, nodes, pg.loop_plans(g))
    damp = pg._damping(D, D_loop, cfg.lm_damping)
    ks = torch.arange(nodes, device=dev)
    free = (ks > 0) & (ks < g.n_nodes)
    eye6 = torch.eye(6, device=dev)
    Dc = torch.where(free[:, None, None], D + D_loop + damp[:, :, None] * eye6 + 1e-6 * eye6, eye6)
    pair = free & torch.roll(free, -1)
    pair[-1] = False
    Bc = torch.where(pair[:, None, None], pg._JtWJ(factors[0].Ji, factors[0].W, factors[0].Jj), 0.0)
    chain = blocktri.factor(Dc, Bc, reg=0.0)
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(nodes, 6)).astype(np.float32))
    got = blocktri.solve(chain, b.to(dev), free, mask_out=True).cpu()
    x = _block_thomas(Dc.double().cpu().numpy(), Bc.double().cpu().numpy(),
                      torch.where(free.cpu()[:, None], b, 0.0).double().numpy())
    assert np.abs(got.numpy() - x).max() / np.abs(x).max() < tol
    cpu = type(chain)(*(t.cpu() for t in chain))
    assert _same_bits(got, chain_solve.chain_solve_plain(*cpu, b[..., None], free.cpu(), True)[..., 0])


# ---------------------------------------------------------------------------
# captured programs (compiled.py) against the same programs eager
# ---------------------------------------------------------------------------

CAPTURED = ("frontend_body_first", "frontend_body_later", "keyframe_prep", "extract_features",
            "odometry_first", "odometry_later", "mapping", "gate", "optimize_chain_cg",
            "optimize_woodbury", "frame_batch_b2", "verify_loop", "sc_make_and_append",
            "sc_detect_latest", "add_keyframe", "add_keyframe_new_sequence", "add_loop")


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, tree)


def _card_chain(n, n_loops, cfg, dev):
    """A drifted straight chain of n nodes with n_loops loop factors."""
    rng = np.random.default_rng(n)
    g = pg.init_graph(cfg, dev, initial_nodes=n, initial_loops=n_loops)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    for k in range(n):
        t = torch.tensor([float(k), 0.05 * k * rng.standard_normal(), 0.0], device=dev)
        g = pg.add_keyframe(g, Pose(ident, t), 0.0, False, n_nodes=k)
    for m in range(n_loops):
        z = Pose(ident, torch.tensor([float(2 * m + 1 - n), 0.0, 0.0], device=dev))
        g = pg.add_loop(g, n - 1 - m, m, z, n_loops=m)
    return g


@pytest.fixture(scope="module")
def card_inputs():
    """The programs' inputs on the card, made eagerly: the states before
    the first frame and after it, the second frame's scan and features."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models import frontend

    dev, cfg = torch.device("cuda"), _config()
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=8), n_frames=2, speed=0.8, radius=25.0, n_azimuth=256, seed=3)
    scans = [LidarScan.from_numpy(s, cfg.sensor.max_points, dev) for s in scans]
    with compiled.disabled():
        s0 = frontend.init_state(cfg, dev)
        s1, _ = frontend.frontend_step(_clone(s0), scans[0], cfg)
        feats = features.extract_features(scans[1], cfg)
    return {"dev": dev, "cfg": cfg, "scans": scans, "s0": s0, "s1": s1, "feats": feats}


def _card_program(name, inp):
    """A call of one captured program on fresh copies of its inputs (the
    donated ones are updated in place)."""
    from scaloam_tpu_torch.models import frontend, mapping, odometry, pipeline
    from scaloam_tpu_torch.parallel import multiseq

    cfg, dev, scans, feats = inp["cfg"], inp["dev"], inp["scans"], inp["feats"]
    s0, s1, full = inp["s0"], inp["s1"], feats.full
    if name in ("verify_loop", "sc_make_and_append", "sc_detect_latest", "add_keyframe",
                "add_keyframe_new_sequence", "add_loop"):
        return _card_backend_program(name, inp)
    if name.startswith("optimize"):
        pcfg = cfg.pgo if name == "optimize_chain_cg" else dataclasses.replace(
            cfg.pgo, wb_min_nodes=64)
        assert pg.uses_woodbury(64, 4, pcfg) == (name == "optimize_woodbury")
        graph = _card_chain(64, 4, pcfg, dev)
        return lambda: pg.optimize(graph, pcfg)
    xyz = torch.stack([scans[1].xyz, scans[0].xyz])
    mask = torch.stack([scans[1].mask, scans[0].mask])
    return {
        "frontend_body_first": lambda: frontend._step_body(_clone(s0), scans[1], cfg),
        "frontend_body_later": lambda: frontend._step_body(_clone(s1), scans[1], cfg),
        "keyframe_prep": lambda: pipeline._prepare_keyframe(
            full.xyz, full.mask, full.rel_time, cfg),
        "extract_features": lambda: features.extract_features(scans[1], cfg),
        "odometry_first": lambda: odometry.odometry_step(s0.o, feats, cfg),
        "odometry_later": lambda: odometry.odometry_step(s1.o, feats, cfg),
        "mapping": lambda: mapping.mapping_step(
            _clone(s1.m), s1.o.world, feats.less_sharp, feats.less_flat, cfg),
        "gate": lambda: pipeline.gate_step(
            s1.gate, s1.m.pose.quat, s1.m.pose.trans, 0.5, 10.0),
        "frame_batch_b2": lambda: multiseq.frame_batch(
            *multiseq.init_states(2, cfg, dev), xyz, mask, cfg),
    }[name]


def _card_backend_program(name, inp):
    """The keyframe backend's programs on the card, fresh copies of the
    donated tables each call."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.models import pipeline, scancontext as scm
    from scaloam_tpu_torch.ops import icp

    cfg, dev, full = inp["cfg"], inp["dev"], inp["feats"].full
    if name == "verify_loop":
        rng = np.random.default_rng(6)
        tgt = rng.uniform(-12, 12, (4096, 3)).astype(np.float32)
        tgt[:, 2] *= 0.2
        c, s = np.cos(0.1), np.sin(0.1)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        src = torch.from_numpy(((tgt[:2048] - [0.8, -0.4, 0.1]) @ rot).astype(np.float32)).to(dev)
        tgt = torch.from_numpy(tgt).to(dev)
        ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
        inits = Pose(torch.tensor([[1.0, 0, 0, 0], [np.cos(-0.05), 0, 0, np.sin(-0.05)]],
                                  dtype=torch.float32, device=dev),
                     torch.zeros((2, 3), device=dev))
        kw = dict(voxel_size=0.4, sub_capacity=4096, gx=16, gy=16, gz=16, cell_size=2.0,
                  cell_cap=32, dedup_radius=0.4, reach=2.0, max_corr_dist=150.0,
                  coarse_iterations=12, fine_iterations=10, transformation_eps=1e-6)
        args = (src, ones(2048), src[::8].clone(), ones(256), tgt[::4].clone(), ones(1024), tgt,
                ones(4096), inits)
        return lambda: icp.verify_loop(*args, **kw)
    with compiled.disabled():
        kf_xyz, kf_mask, _ = pipeline._prepare_keyframe(full.xyz, full.mask, full.rel_time, cfg)
        db = scm.init_db(cfg.scancontext, dev)  # room for every append below
        for k in range(cfg.scancontext.num_exclude_recent + 3):
            db, _ = scm.make_and_append(db, kf_xyz + 0.5 * k, kf_mask, cfg.scancontext)
        graph = _card_chain(64, 4, cfg.pgo, dev)
    if name == "sc_make_and_append":
        return lambda: scm.make_and_append(_clone(db), kf_xyz, kf_mask, cfg.scancontext)
    if name == "sc_detect_latest":
        return lambda: scm.detect_latest(db, cfg.scancontext)
    pose = Pose(torch.tensor([0.0, 0.6, 0.0, 0.8], device=dev),
                torch.tensor([8.0, 0.5, 0.2], device=dev))
    if name == "add_loop":
        i, j = torch.tensor(60, device=dev), torch.tensor(3, device=dev)
        return lambda: pg.add_loop_jit(_clone(graph), i, j, pose)
    z, ok = torch.tensor(1.5, device=dev), torch.tensor(1.0, device=dev)
    return lambda: pg.add_keyframe_jit(_clone(graph), pose, z, ok,
                                       new_sequence=name == "add_keyframe_new_sequence")


@pytest.mark.parametrize("name", CAPTURED)
def test_captured_program_replays_its_eager_outputs(card_inputs, name):
    """Each program the port captures, replayed, gives what the same
    program gives eagerly (compiled.disabled()) on the same inputs, held
    by chip_smoke.py's (j) rule: bit for bit where two eager calls agree
    bit for bit, otherwise every integer and bool output equal and the
    float ones within the eager calls' difference."""
    import chip_smoke
    from scaloam_tpu_torch import compiled

    call = _card_program(name, card_inputs)
    with compiled.disabled():
        e1, e2 = call(), call()
    call()  # the first call on the key runs eagerly, then captures
    got = call()  # a replay
    torch.cuda.synchronize()
    leaves = [pytree.tree_leaves(x) for x in (got, e1, e2)]
    assert [x for x in leaves[0] if not torch.is_tensor(x)] == [
        x for x in leaves[1] if not torch.is_tensor(x)]
    tensors = [[x for x in ls if torch.is_tensor(x)] for ls in leaves]
    chip_smoke.j_compare(torch, name, dict(zip(("captured", "eager", "eager 2"), tensors)))


# ---------------------------------------------------------------------------
# spans at the compile boundary and the front end (utils/timing.py)
# ---------------------------------------------------------------------------


def test_a_captured_replay_records_the_bytes_its_boundary_moves(dev):
    """A toy step's replay on the card, under the profiler: its spans carry
    exactly the bytes of compiled.boundary_bytes over its leaves and of the
    graph's copy of the donated state into its buffers."""
    from scaloam_tpu_torch import compiled
    from scaloam_tpu_torch.utils import timing

    @compiled.jit(donate_argnums=(0,))
    def step(state, x):
        pos, count = state
        return (pos + x, count + 1), (pos * 2.0).sum(dim=-1)

    state = (torch.zeros((1000, 3), device=dev), torch.zeros((), dtype=torch.int32, device=dev))
    x = torch.ones((1000, 3), device=dev)
    state, _ = step(state, x)  # eager, then captured
    state, _ = step(state, x)  # a replay with tracing off
    with timing.span("off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        state, y = step(state, x)
    recs = {r.name: r for r in timing.records()}
    leaves = [state[0], state[1], x]
    copy_in, write_back, clone = compiled.boundary_bytes(
        leaves, {0: 0, 1: 1}, [state[0], state[1], y])
    assert (copy_in, write_back, clone) == (12000 + 4 + 12000, 12004, 4000)
    assert recs["compiled.copy_in"].counts == {"compiled.copy_in_bytes": copy_in}
    assert recs["compiled.launch"].counts == {"compiled.keep_bytes": 12004}
    assert recs["compiled.outputs"].counts == {"compiled.write_back_bytes": write_back,
                                               "compiled.clone_bytes": clone}
    replay = recs[f"compiled.replay:{__name__}.step"]
    assert recs["compiled.launch"].parent == replay.id
    assert torch.equal(state[0], torch.full_like(x, 3.0)) and int(state[1]) == 3


def test_frontend_step_on_card_reads_the_gate_once_a_step(dev):
    from scaloam_tpu_torch.utils import timing

    cfg = _config()
    world = synthetic.make_world(seed=0, n_boxes=40, extent=50.0)
    scans, _ = synthetic.simulate_trajectory(world, n_frames=5, speed=1.0, radius=20.0,
                                             n_azimuth=256, n_scans=cfg.sensor.n_scans,
                                             lidar_type=cfg.sensor.lidar_type)
    fe = FrontEnd(cfg, device=dev)
    for points in scans[:2]:  # both keys captured
        scan = LidarScan.from_numpy(np.asarray(points), cfg.sensor.max_points, dev)
        fe.step(scan.xyz, scan.mask)
    with timing.span("off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        for points in scans[2:]:
            scan = LidarScan.from_numpy(np.asarray(points), cfg.sensor.max_points, dev)
            fe.step(scan.xyz, scan.mask)
        torch.cuda.synchronize()
    recs = timing.records()
    steps = [r for r in recs if r.name == "frontend.step"]
    reads = [r for r in recs if r.name == "frontend.gate_read"]
    assert len(steps) == len(reads) == 3
    assert [r.parent for r in reads] == [r.id for r in steps]
    assert all(r.device_ms > 0 and r.counts == {"scans": 1} for r in steps)
    replays = [r for r in recs if r.name == "compiled.replay:models.frontend._step_body"]
    assert len(replays) == 3
    assert "compiled.capture:models.frontend._step_body" not in {r.name for r in recs}
    uploads = [r for r in recs if r.name == "scan.upload"]
    assert [r.counts for r in uploads] == [{"scan.upload_bytes": cfg.sensor.max_points * 13}] * 3
