"""The ring-id and azimuth pass (ops/kernels/ring_azimuth.py, one launch a
frame on the card) and the chain preconditioner's solve
(ops/kernels/chain_solve.py, one launch a call), their plain versions on
the CPU.

Tolerances:
- ring_azimuth's plain version against the port's former composition
  (chip_smoke.former_ring_azimuth: the ring formula around ops/f32.py's
  atan2, then -atan2(y, x)): equal bit for bit (the same operations,
  regrouped), for each sensor on a synthetic frame and on points placed on
  its ring bounds (the last ulp of the angle decides there);
- extract_features at each preset (reduced capacities) equal bit for bit
  to the tree before that pass: a sha256 of every output tensor, recorded
  from that tree's run of the same frame (FEATURE_DIGESTS);
- the plain chain solve against the JAX reference's solve
  (scaloam_tpu/ops/blocktri.py) within 1e-4 of the solution's largest
  entry, with and without the per-level floor `reg`, masked as each
  caller masks, and against a float64 dense solve without the floor (the
  floor changes the factor); equal bit for bit to the former composition
  (chip_smoke.former_chain_solve: batched matmuls, which the CPU sums from
  the first term for such small products);
- one op call (one launch on the card) a solve of an optimise and one
  ring_azimuth a frame.
"""

import dataclasses
import functools
import hashlib

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from scaloam_tpu.ops import blocktri as jbt
from scaloam_tpu_torch import config as tconfig
from scaloam_tpu_torch.models import posegraph as tpg
from scaloam_tpu_torch.ops import blocktri, features
from scaloam_tpu_torch.ops.kernels import chain_solve, ring_azimuth
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils import synthetic
from torch_threads import two_threads  # noqa: F401  (autouse)

SOLVE_REL_TOL = 1e-4
LIDARS = sorted(chip_smoke.RING_BOUNDS)


def _frame(lidar, n_scans, seed, n_azimuth=240):
    """A synthetic frame of the sensor with a NaN point and a near one."""
    pts = synthetic.simulate_scan(synthetic.make_world(seed), np.array([0.5, -0.3, 1.7]), 0.2,
                                  n_scans=n_scans, n_azimuth=n_azimuth, lidar_type=lidar,
                                  seed=seed)
    pts[5] = np.nan
    pts[17] = [0.5, 0.2, 0.1]
    return pts


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


# ---------------------------------------------------------------- ring_azimuth


@pytest.mark.parametrize("lidar", LIDARS)
def test_ring_azimuth_plain_is_the_former_composition(lidar):
    n_scans = chip_smoke.RING_BOUNDS[lidar][0]
    xyz = torch.from_numpy(np.concatenate([
        _frame(lidar, n_scans, 3), chip_smoke.ring_bound_points(lidar),
        np.random.default_rng(4).uniform(-80, 80, (2000, 3)).astype(np.float32)]))
    got = ring_azimuth.ring_azimuth(xyz, lidar, n_scans)
    want = chip_smoke.former_ring_azimuth(torch, xyz, lidar, n_scans)[:3]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert got[1].any() and not got[1].all()  # in and out of the sensor's rings
    assert ring_azimuth.ring_azimuth.launches == 0  # the CPU runs the plain version


def _reduced(preset):
    cfg = tconfig.PRESETS[preset]()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(cfg.features, max_sharp=256, max_less_sharp=1024,
                                     max_flat=512, max_less_flat=4096))


# sha256 of extract_features' outputs (every tensor's dtype, shape and bytes,
# in tree order) on _frame(seed 3, 240 columns) at _reduced(preset), from
# the tree before ring_azimuth
FEATURE_DIGESTS = {
    "hdl32": "414bed7fc501bef76dc18cec981ed98454e2693c7c6f2d3444f08d7d874bc66d",
    "kitti_hdl64": "6e7acb9ec3a7a714dbd68c53247541f039090bad901c0cd01b31380a9536448b",
    "mulran_os1_64": "653160af7fafa11bd2f975f30924c60d3fa53b46e7092be47f7993b671caade8",
    "vlp16": "faebab3f80f37e3c7772a2413f306368fa912a2452eb020bede1eab6e1dc83b7",
}


@pytest.mark.parametrize("preset", sorted(FEATURE_DIGESTS))
def test_extract_features_is_bit_equal_to_the_former_composition(preset):
    cfg = _reduced(preset)
    s = cfg.sensor
    pts = _frame(s.lidar_type, s.n_scans, 3)[: s.max_points - 8]
    before = ring_azimuth.ring_azimuth.launches
    out = features.extract_features(LidarScan.from_numpy(pts, s.max_points, "cpu"), cfg)
    h = hashlib.sha256()
    for leaf in pytree.tree_leaves(out):
        a = leaf.numpy()
        h.update(str((a.dtype, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    assert int(out.less_sharp.mask.sum()) > 0 and int(out.flat.mask.sum()) > 0
    assert h.hexdigest() == FEATURE_DIGESTS[preset]
    assert ring_azimuth.ring_azimuth.launches == before


# ---------------------------------------------------------------- chain solve


def _chain_system(n, r):
    rng = np.random.default_rng(n + (r or 0))
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    D = np.einsum("nij,nkj->nik", A, A) + 6.0 * np.eye(6, dtype=np.float32)
    B = 0.4 * rng.normal(size=(n, 6, 6)).astype(np.float32)
    B[-1] = 0.0
    b = rng.normal(size=(n, 6) if r is None else (n, 6, r)).astype(np.float32)
    free = rng.uniform(size=n) > 0.2
    free[0] = n == 1  # node 0 frozen, as in the optimise, where it has neighbours
    return D, B, b, free


@functools.lru_cache(maxsize=None)
def _jax_factor(n, reg):
    D, B, _, _ = _chain_system(n, None)
    return jbt.factor(jnp.asarray(D), jnp.asarray(B), reg=reg)


def _dense_solve(D, B, b):
    n = D.shape[0]
    H = np.zeros((6 * n, 6 * n))
    for i in range(n):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
        if i + 1 < n:
            H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = B[i]
            H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = B[i].T
    return np.linalg.solve(H, b.reshape(6 * n, -1)).reshape(b.shape)


@pytest.mark.parametrize("n,r", [(1, None), (13, None), (32, None), (256, None), (1, 5),
                                 (13, 5), (32, 5), (256, 5)])
def test_chain_solve_plain_matches_reference_and_float64(n, r):
    D, B, b, free_np = _chain_system(n, None)
    if r is not None:
        b = _chain_system(n, r)[2]
    fm = free_np.reshape((n,) + (1,) * (b.ndim - 1))
    free = torch.from_numpy(free_np)
    for reg in (0.0, 1e-5):
        chain = blocktri.factor(torch.from_numpy(D), torch.from_numpy(B), reg=reg)
        assert chain.Do_inv.shape == chain.L.shape == chain.R.shape == (
            max(1, 1 << (n - 1).bit_length()) - 1, 6, 6)
        for mode in ("none", "input", "both"):  # the Woodbury setup, its CG, chain-CG
            b_in = b if mode == "none" else np.where(fm, b, 0.0).astype(np.float32)
            want = np.asarray(jbt.solve(_jax_factor(n, reg), jnp.asarray(b_in)))
            got = blocktri.solve(chain, torch.from_numpy(b), None if mode == "none" else free,
                                 mask_out=mode == "both").numpy()
            if mode == "both":
                want = np.where(fm, want, 0.0)
            scale = np.abs(want).max()
            assert np.abs(got - want).max() / scale < SOLVE_REL_TOL, (reg, mode)
            if reg == 0.0:
                x = _dense_solve(D.astype(np.float64), B.astype(np.float64),
                                 b_in.astype(np.float64))
                x = np.where(fm, x, 0.0) if mode == "both" else x
                assert np.abs(got - x).max() / scale < SOLVE_REL_TOL, mode
            former = chip_smoke.former_chain_solve(
                torch, chain, torch.from_numpy(b), None if mode == "none" else free,
                mode == "both")
            assert torch.equal(_bits(torch.from_numpy(got)), _bits(former))


def test_chain_solve_without_free_rejects_mask_out():
    D, B, b, _ = _chain_system(13, None)
    chain = blocktri.factor(torch.from_numpy(D), torch.from_numpy(B))
    with pytest.raises(ValueError):
        blocktri.solve(chain, torch.from_numpy(b), None, mask_out=True)


@pytest.mark.parametrize("solver", ["chain_cg", "woodbury"])
def test_an_optimise_solves_the_chain_once_a_call(solver, monkeypatch):
    """chain-CG: one solve a CG step and one before, a GN iteration;
    Woodbury: the setup's wide solve, then the same a GN iteration."""
    calls = []
    op = chain_solve._chain_solve_op

    def counted(*args):
        calls.append(tuple(args[4].shape))
        return op(*args)

    monkeypatch.setattr(chain_solve, "_chain_solve_op", counted)
    n, nl = 48, 4
    _, oq, ot, loops = chip_smoke.circle_chain(n, nl, seed=2, lap=24)
    cfg = dataclasses.replace(chip_smoke.chain_pgo_cfg(tconfig.PGOConfig(), n, nl),
                              gn_iterations=2, solver=solver, wb_min_nodes=1, wb_cg_iters=5)
    g = chip_smoke.build_graph(torch, tpg, Pose, cfg, oq, ot, loops, "cpu")
    assert tpg.uses_woodbury(n, nl, cfg) == (solver == "woodbury")
    tpg.optimize(g, cfg, cg_iters=7)
    steps = cfg.wb_cg_iters if solver == "woodbury" else 7
    wide = [(n, 6, 6 * nl)] if solver == "woodbury" else []
    assert calls == wide + [(n, 6, 1)] * (cfg.gn_iterations * (steps + 1))


def test_a_frame_runs_one_ring_and_azimuth_pass(monkeypatch):
    calls = []
    op = ring_azimuth._ring_azimuth_op

    def counted(*args):
        calls.append(args[1:])
        return op(*args)

    monkeypatch.setattr(ring_azimuth, "_ring_azimuth_op", counted)
    cfg = _reduced("mulran_os1_64")
    s = cfg.sensor
    pts = _frame(s.lidar_type, s.n_scans, 5)
    features.extract_features(LidarScan.from_numpy(pts, s.max_points, "cpu"), cfg)
    assert calls == [("OS1-64", 64)]
