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
for bit, on the card and on the CPU, and vmapped in one launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scaloam_tpu_torch import config
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
    batched frame; poses within 5e-4 / 5e-3 m of the same batch on the
    CPU."""
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
            counts = (selection.select_features.launches, gn_odometry.associate_and_solve.launches,
                      gn_odometry.gn_solve_prepared.launches)
            o, m, odom, mapped = multiseq.frame_batch(
                *states[d], torch.stack([s.xyz for s in scans]),
                torch.stack([s.mask for s in scans]), cfg)
            states[d] = (o, m)
            poses[str(d)] = (odom, mapped)
            if d == dev:
                torch.cuda.synchronize()
                assert (selection.select_features.launches - counts[0],
                        gn_odometry.associate_and_solve.launches - counts[1],
                        gn_odometry.gn_solve_prepared.launches - counts[2]) == (
                            1, int(f > 0), cfg.mapping.outer_iterations)
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
