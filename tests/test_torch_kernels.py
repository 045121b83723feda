"""The port's two kernels against the JAX reference.

On the CPU each wrapper takes its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode. K1 (feature selection) must
match exactly, and a numpy model of the CUDA kernel's sort-and-walk
algorithm must equal the plain version exactly. K2's entry A (associate +
GN) must give the same counts, the quaternion within 2e-4 and the
translation within 2e-3 (the reference's own Pallas-vs-XLA tolerances:
same math, f32 sums in another order); its entry B (GN over prepared
factors, mapping's loop) is held to the reference's gn.gauss_newton at
the same tolerances.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py, which imports no JAX."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scaloam_tpu.ops import gn as jgn, residuals as jres, se3 as jse3
from scaloam_tpu.ops.pallas import gn_odometry as jgnk
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu_torch import config as tconfig
from scaloam_tpu_torch.ops import features as tfeat
from scaloam_tpu_torch.ops.kernels import gn_odometry as tgnk
from scaloam_tpu_torch.ops.kernels import selection as tsel
from scaloam_tpu_torch.types import LidarScan
from scaloam_tpu_torch.utils import synthetic

SEL_KW = dict(n_sub=6, n_corner=20, n_flat=4, curv_thr=0.1)
K2_KW = dict(outer_iterations=2, gn_iterations=4, thr=25.0, huber_delta=0.1)


def _scan_selection_inputs():
    """Selection inputs of one synthetic HDL-64 scan at a 384-wide image."""
    cfg = tconfig.kitti_hdl64()
    cfg = cfg.replace(sensor=dataclasses.replace(cfg.sensor, max_points=16384,
                                                 max_points_per_ring=384))
    world = synthetic.make_world(seed=21)
    pts = synthetic.simulate_scan(world, np.array([0.0, 0.0, 1.8]), 0.4, n_azimuth=250, seed=5)
    si = tfeat.selection_inputs(LidarScan.from_numpy(pts, 16384, "cpu"), cfg)
    return si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep


def _tie_inputs(seed, S=16, W=300, n_sub=6, bounds="split"):
    """Quantized curvature (many exact ties on both sides of the 0.1
    threshold), random reach and eligibility. Subregion bounds: "split"
    (the reference's even split), "empty" (every other subregion has
    ep < sp) or "overlap" (random spans that overlap)."""
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
    t = lambda a, dt: torch.tensor(a, dtype=dt)
    return (
        t(rng.integers(0, 8, (S, W)) * 0.05, torch.float32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t((np.arange(W) >= 5) & (np.arange(W) <= 4 + L[:, None]) & (rng.uniform(size=(S, W)) < 0.9), torch.bool),
        t(sp, torch.int32),
        t(ep, torch.int32),
    )


def _selection_case(inputs):
    """(args, selection keywords) of a named selection input."""
    if inputs == "scan":
        return _scan_selection_inputs(), SEL_KW
    if inputs == "nsub1":  # one subregion spanning the row: long lists
        return _tie_inputs(2, n_sub=1), dict(SEL_KW, n_sub=1)
    if inputs in ("empty", "overlap"):
        return _tie_inputs(3, bounds=inputs), SEL_KW
    return _tie_inputs(int(inputs[-1])), SEL_KW


@pytest.mark.parametrize("inputs", ["scan", "ties0", "ties1"])
def test_selection_plain_matches_pallas_interpret(inputs):
    args, kw = _selection_case(inputs)
    want = jsel.select_features(*(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True)
    got = tsel.select_features(*args, **kw)  # CPU tensors: the plain version
    for name, w, g in zip(("corner_idx", "corner_ok", "flat_idx", "flat_ok", "labels"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[1].sum()) > 0 and int(got[3].sum()) > 0


def _ord_f32(c):
    """csrc/selection.cu:ord_f32: order-preserving int of a float32 (-0 as +0)."""
    c = np.where(c == 0, np.float32(0), c).astype(np.float32)
    i = c.view(np.int32).astype(np.int64)
    return np.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _sort_and_walk(curv, left, right, elig, sp, ep, n_sub, n_corner, n_flat, curv_thr):
    """Numpy model of K1's algorithm: 64-bit keys, rank-counted lists per
    subregion, one cursor per list, a pick = the first entry whose flag is 1
    in the window of 32 // n_sub entries from the cursor (the window slides
    on while it holds none), the cursor moved to it."""
    curv, left, right, elig, sp, ep = (a.numpy() for a in (curv, left, right, elig, sp, ep))
    S, W = curv.shape
    thr = np.float32(curv_thr)
    ord_thr = int(_ord_f32(np.array([thr]))[0])
    ord_neg_inf = int(_ord_f32(np.array([-np.inf], np.float32))[0])
    ci = np.zeros((S, n_sub, n_corner), np.int32)
    co = np.zeros((S, n_sub, n_corner), bool)
    fi = np.zeros((S, n_sub, n_flat), np.int32)
    fo = np.zeros((S, n_sub, n_flat), bool)
    labels = np.zeros((S, W), bool)
    jj = np.arange(W)
    for row in range(S):
        c, o = curv[row], _ord_f32(curv[row])
        corner, flat = elig[row] & (c > thr), elig[row] & (c < thr)
        k = np.where(corner, o, ord_thr - 1 + ord_neg_inf - o)
        key = ((k + 2**31).astype(np.uint64) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - jj.astype(np.uint64))
        key = np.where(corner | flat, key, np.uint64(0))
        lists, cursors = [], []
        for s in range(n_sub):
            seg = jj[max(sp[row, s], 0): min(ep[row, s], W - 1) + 1]
            members = seg[key[seg] > 0]
            rank = (key[seg][None, :] > key[members][:, None]).sum(axis=1)
            lst = np.empty(len(members), np.int64)
            lst[rank] = members
            nc = int(corner[members].sum())
            lists.append((lst[:nc], lst[nc:]))
            cursors.append([0, 0])
        flag = elig[row].astype(np.int8)
        lo_ext, hi_ext = np.clip(left[row], 0, W), np.clip(right[row], 0, W)
        win = 32 // n_sub  # the kernel's lanes per subregion
        for p in range(n_corner + n_flat):
            is_corner = p < n_corner
            suppress = is_corner or p - n_corner < n_flat - 1
            cls = 0 if is_corner else 1
            for s in range(n_sub):
                lst, cur, found, jstar = lists[s][cls], cursors[s][cls], False, 0
                while cur < len(lst):
                    avail = flag[lst[cur:cur + win]] == 1
                    if avail.any():
                        first = int(np.argmax(avail))
                        jstar, cur, found = int(lst[cur + first]), cur + first, True
                        break
                    cur += win
                cursors[s][cls] = min(cur, len(lst))
                if found and suppress:
                    flag[max(jstar - lo_ext[jstar], 0): min(jstar + hi_ext[jstar], W - 1) + 1] = 2
                if is_corner:
                    ci[row, s, p], co[row, s, p] = jstar, found
                    labels[row, jstar] |= found
                else:
                    fi[row, s, p - n_corner], fo[row, s, p - n_corner] = jstar, found
    return ci, co, fi, fo, labels


@pytest.mark.parametrize("inputs", ["scan", "ties0", "ties1", "nsub1", "empty", "overlap"])
def test_selection_sort_and_walk_matches_plain(inputs):
    """The CUDA kernel's algorithm, modelled in numpy, equals the plain
    version exactly (the card checks the kernel itself against the plain
    version in tests/test_torch_cuda.py and chip_smoke.py)."""
    args, kw = _selection_case(inputs)
    want = tsel.select_features_plain(*args, **kw)
    got = _sort_and_walk(*args, **kw)
    for name, w, g in zip(("corner_idx", "corner_ok", "flat_idx", "flat_ok", "labels"), want, got):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert want[1].sum() > 0 and want[3].sum() > 0


def _scenario(seed, n_c=256, n_s=512, frac_valid=0.8):
    """The reference's test scenario (tests/test_pallas_gn.py): candidates
    are ground-truth transformed points plus small class-consistent
    offsets. Returns the point/candidate arrays in numpy."""
    rng = np.random.default_rng(seed)
    q_gt = jse3.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32))
    gt = JPose(q_gt, jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32))

    def cloud(n):
        return rng.uniform(-20, 20, size=(n, 3)).astype(np.float32), rng.uniform(size=n) < frac_valid

    c_xyz, c_mask = cloud(n_c)
    s_xyz, s_mask = cloud(n_s)
    cw, sw = np.asarray(jse3.apply(gt, c_xyz)), np.asarray(jse3.apply(gt, s_xyz))

    def cands(base, spread):
        return base[:, None, :] + rng.normal(0, spread, size=(base.shape[0], 2, 3)).astype(np.float32)

    return (c_xyz, cands(cw, 0.05), cands(cw, 0.3), c_mask,
            s_xyz, cands(sw, 0.05), cands(sw, 0.2), cands(sw, 0.3), s_mask)


def _all_invalid():
    n_c, n_s = 64, 128
    z = lambda *s: np.zeros(s, np.float32)
    return (z(n_c, 3), z(n_c, 2, 3), z(n_c, 2, 3), np.zeros(n_c, bool),
            z(n_s, 3), z(n_s, 2, 3), z(n_s, 2, 3), z(n_s, 2, 3), np.zeros(n_s, bool))


def _k2_jax(arrs, q0, t0):
    c_xyz, c_any, c_oth, c_mask, s_xyz, s_any, s_same, s_oth, s_mask = map(jnp.asarray, arrs)
    cpack = jgnk.pack_corner(c_xyz, c_any, c_oth, c_mask)
    spack = jgnk.pack_surf(s_xyz, s_any, s_same, s_oth, s_mask)
    q, t, n_c, n_s = jgnk.associate_and_solve(cpack, spack, jnp.asarray(q0), jnp.asarray(t0),
                                              **K2_KW, interpret=True)
    return np.asarray(q), np.asarray(t), int(n_c), int(n_s)


@pytest.mark.parametrize("case", ["seed0", "seed3", "all_invalid"])
def test_associate_and_solve_plain_matches_pallas_interpret(case):
    arrs = _all_invalid() if case == "all_invalid" else _scenario(int(case[-1]))
    q0 = np.array([1.0, 0, 0, 0], np.float32)
    t0 = np.array([0.5, -0.25, 1.0] if case == "all_invalid" else [0, 0, 0], np.float32)
    wq, wt, wnc, wns = _k2_jax(arrs, q0, t0)
    q, t, n_c, n_s = tgnk.associate_and_solve(*map(torch.tensor, arrs), torch.tensor(q0),
                                              torch.tensor(t0), **K2_KW)
    assert (int(n_c), int(n_s)) == (wnc, wns)
    q = q.numpy()
    if np.dot(q, wq) < 0:
        q = -q
    np.testing.assert_allclose(q, wq, atol=2e-4, rtol=0)
    np.testing.assert_allclose(t.numpy(), wt, atol=2e-3, rtol=0)
    if case == "all_invalid":  # the damped solve leaves the pose unchanged
        np.testing.assert_allclose(t.numpy(), t0, atol=1e-5, rtol=0)


def _prepared_factors(seed, n_c=256, n_s=512, frac_valid=0.8):
    """Mapping-style prepared factors around a ground-truth pose: lines
    through the transformed corner points, planes through the transformed
    surf points, small noise; invalid rows hold NaN (a degenerate fit)."""
    rng = np.random.default_rng(seed)
    gt = JPose(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)),
               jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32))
    c_p = rng.uniform(-20, 20, (n_c, 3)).astype(np.float32)
    s_p = rng.uniform(-20, 20, (n_s, 3)).astype(np.float32)
    cw, sw = np.asarray(jse3.apply(gt, c_p)), np.asarray(jse3.apply(gt, s_p))
    u = rng.normal(size=(n_c, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c_a = (cw + 0.1 * u + rng.normal(0, 0.01, (n_c, 3))).astype(np.float32)
    c_b = (cw - 0.1 * u + rng.normal(0, 0.01, (n_c, 3))).astype(np.float32)
    s_n = rng.normal(size=(n_s, 3))
    s_n = (s_n / np.linalg.norm(s_n, axis=1, keepdims=True)).astype(np.float32)
    s_d = (-np.sum(s_n * sw, axis=1) + rng.normal(0, 0.01, n_s)).astype(np.float32)
    c_v, s_v = rng.uniform(size=n_c) < frac_valid, rng.uniform(size=n_s) < frac_valid
    c_a[~c_v], s_n[~s_v], s_d[~s_v] = np.nan, np.nan, np.nan
    return c_p, c_a, c_b, c_v, s_p, s_n, s_d, s_v


@pytest.mark.parametrize("case", ["seed0", "seed5", "all_invalid"])
def test_gn_solve_prepared_plain_matches_reference(case):
    """K2's prepared-factor entry (mapping's GN loop) on the CPU against the
    reference's gn.gauss_newton over the same edge / plane-normal factors."""
    seed = 1 if case == "all_invalid" else int(case[4:])
    arrs = _prepared_factors(seed, frac_valid=0.0 if case == "all_invalid" else 0.8)
    c_p, c_a, c_b, c_v, s_p, s_n, s_d, s_v = arrs
    q0 = np.array([1.0, 0, 0, 0], np.float32)
    t0 = np.array([0.5, -0.25, 1.0], np.float32)
    prep = jres.edge_prep_T(*(jnp.asarray(x) for x in (c_p.T, c_a.T, c_b.T, c_v)))
    build = lambda p: [jres.edge_factors_from_prep(p, prep),
                       jres.plane_norm_factors_T(p, *(jnp.asarray(x) for x in (s_p.T, s_n.T, s_d, s_v)))]
    want = jgn.gauss_newton(JPose(jnp.asarray(q0), jnp.asarray(t0)), build, 4, 0.1)
    q, t = tgnk.gn_solve_prepared(torch.tensor(q0), torch.tensor(t0), *map(torch.tensor, arrs),
                                  gn_iterations=4, huber_delta=0.1)
    wq, wt = np.asarray(want.quat), np.asarray(want.trans)
    q = q.numpy()
    if np.dot(q, wq) < 0:
        q = -q
    np.testing.assert_allclose(q, wq, atol=2e-4, rtol=0)
    np.testing.assert_allclose(t.numpy(), wt, atol=2e-3, rtol=0)
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(t.numpy()))
    if case == "all_invalid":
        np.testing.assert_allclose(t.numpy(), t0, atol=1e-5, rtol=0)
    else:  # the solve moved toward the ground truth
        assert np.abs(t.numpy() - t0).max() > 0.1
