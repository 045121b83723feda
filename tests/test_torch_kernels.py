"""The port's two kernels against the JAX reference's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode. K1 (feature selection) must
match exactly; K2 (associate + GN) must give the same counts, the
quaternion within 2e-4 and the translation within 2e-3 (the reference's
own Pallas-vs-XLA tolerances: same math, f32 sums in another order).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py, which imports no JAX."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scaloam_tpu.ops import se3 as jse3
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


def _tie_inputs(seed, S=16, W=300):
    """Quantized curvature (many exact ties on both sides of the 0.1
    threshold), random reach and eligibility, reference-style bounds."""
    rng = np.random.default_rng(seed)
    L = rng.integers(W // 2, W - 10, size=S)
    j = np.arange(6)
    t = lambda a, dt: torch.tensor(a, dtype=dt)
    return (
        t(rng.integers(0, 8, (S, W)) * 0.05, torch.float32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t(rng.integers(0, 6, (S, W)), torch.int32),
        t((np.arange(W) >= 5) & (np.arange(W) <= 4 + L[:, None]) & (rng.uniform(size=(S, W)) < 0.9), torch.bool),
        t(5 + (L[:, None] * j) // 6, torch.int32),
        t(5 + (L[:, None] * (j + 1)) // 6 - 1, torch.int32),
    )


@pytest.mark.parametrize("inputs", ["scan", "ties0", "ties1"])
def test_selection_plain_matches_pallas_interpret(inputs):
    args = _scan_selection_inputs() if inputs == "scan" else _tie_inputs(int(inputs[-1]))
    want = jsel.select_features(*(jnp.asarray(a.numpy()) for a in args), **SEL_KW, interpret=True)
    got = tsel.select_features(*args, **SEL_KW)  # CPU tensors: the plain version
    for name, w, g in zip(("corner_idx", "corner_ok", "flat_idx", "flat_ok", "labels"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[1].sum()) > 0 and int(got[3].sum()) > 0


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
