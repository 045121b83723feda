"""The port's pose graph (scaloam_tpu_torch.models.posegraph) against the
JAX reference on the CPU: the scenarios of tests/test_posegraph.py on both
solver tiers (chain-preconditioned CG and Woodbury, forced through
wb_min_nodes), the captured graph tests/data_pgo_regression_graph.npz, the
Woodbury step against a dense f64 solve, and capacity growth.

Tolerances: graph poses within 1e-4 (quaternion, sign aligned) and 1e-3 m
of the reference; the Woodbury step within 5e-3 of the dense solve,
relative to its largest entry (the reference's own test bound).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import posegraph as jpg
from scaloam_tpu.ops import se3 as jse3
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import posegraph as tpg
from scaloam_tpu_torch.types import Pose as TPose

Q_TOL, T_TOL = 1e-4, 1e-3
CPU = "cpu"


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_quat(got, want, tol, what=""):
    got, want = _np(got).reshape(-1, 4), _np(want).reshape(-1, 4)
    sign = np.where(np.sum(got * want, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, atol=tol, rtol=0, err_msg=what)


def _circle(n, radius=20.0):
    th = 2 * np.pi * np.arange(n) / n
    q = np.asarray(jse3.rpy_to_quat(jnp.zeros(n), jnp.zeros(n), jnp.asarray(th, jnp.float32)))
    t = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), np.zeros(n)], -1)
    return q.astype(np.float32), t.astype(np.float32)


def _drift(q, t, rng, rot_sigma=0.002, t_sigma=0.02):
    """Integrate noisy relative motions (numpy in, numpy out, via JAX se3)."""
    gq, gt = jnp.asarray(q), jnp.asarray(t)
    oq, ot = [gq[0]], [gt[0]]
    for k in range(1, len(q)):
        rel = jse3.relative(JPose(gq[k - 1], gt[k - 1]), JPose(gq[k], gt[k]))
        dq = jse3.exp_so3(jnp.asarray(rng.normal(0, rot_sigma, 3), jnp.float32))
        rel = JPose(jse3.quat_mul(rel.quat, dq),
                    rel.trans + jnp.asarray(rng.normal(0, t_sigma, 3), jnp.float32))
        p = jse3.compose(JPose(oq[-1], ot[-1]), rel)
        oq.append(p.quat)
        ot.append(p.trans)
    return np.asarray(jnp.stack(oq)), np.asarray(jnp.stack(ot))


def _rel(q, t, a, b):
    r = jse3.relative(JPose(jnp.asarray(q[a]), jnp.asarray(t[a])),
                      JPose(jnp.asarray(q[b]), jnp.asarray(t[b])))
    return np.asarray(r.quat), np.asarray(r.trans)


def _build_both(cfg, oq, ot, loops=(), gps=None):
    """The same graph through both packages' add_keyframe / add_loop."""
    jg, tg = jpg.init_graph(cfg), tpg.init_graph(tconfig.PGOConfig(**dataclasses.asdict(cfg)), CPU)
    for k in range(len(oq)):
        z, ok = (0.0, False) if gps is None else (gps[k], True)
        jg = jpg.add_keyframe(jg, JPose(jnp.asarray(oq[k]), jnp.asarray(ot[k])),
                              jnp.float32(z), jnp.asarray(ok))
        tg = tpg.add_keyframe(tg, TPose(_t(oq[k]), _t(ot[k])), np.float32(z), ok, n_nodes=k)
    for n, (i, j, zq, zt) in enumerate(loops):
        jg = jpg.add_loop(jg, jnp.int32(i), jnp.int32(j), JPose(jnp.asarray(zq), jnp.asarray(zt)))
        tg = tpg.add_loop(tg, i, j, TPose(_t(zq), _t(zt)), n_loops=n)
    return jg, tg


def _assert_graph(tg, jg, n, qtol=Q_TOL, ttol=T_TOL):
    _assert_quat(tg.poses.quat[:n], np.asarray(jg.poses.quat)[:n], qtol, "graph quat")
    np.testing.assert_allclose(tg.poses.trans.numpy()[:n], np.asarray(jg.poses.trans)[:n],
                               atol=ttol, rtol=0)


def _loops(q, t, n, k_loops):
    return [(n - 1 - k, k) + _rel(q, t, n - 1 - k, k) for k in range(k_loops)]


def _optimize_both(cfg, jg, tg, cg_iters=64):
    tcfg = tconfig.PGOConfig(**dataclasses.asdict(cfg))
    return jpg.optimize(jg, cfg, cg_iters=cg_iters), tpg.optimize(tg, tcfg, cg_iters=cg_iters)


CFG = jconfig.PGOConfig(max_keyframes=128, max_loops=16, gn_iterations=10)
LOOPY = dict(loop_variance=1e-3, gn_iterations=12, cauchy_k=100.0)


@pytest.mark.parametrize("scenario", [
    "fixed_point", "loop_chain_cg", "loop_woodbury", "gps", "robust_outlier",
])
def test_optimize_matches_reference(scenario):
    rng = np.random.default_rng(0)
    n = {"fixed_point": 20, "gps": 40, "robust_outlier": 50}.get(scenario, 60)
    q, t = _circle(n)
    cfg, loops, gps, cg_iters = CFG, [], None, 64
    if scenario == "fixed_point":
        oq, ot = q, t
    elif scenario == "gps":
        oq, ot = q, t + np.outer(0.05 * np.arange(n), [0, 0, 1]).astype(np.float32)
        gps = np.zeros(n, np.float32)
        cfg = dataclasses.replace(CFG, gps_z_variance=0.01, cauchy_k=100.0)
    elif scenario == "robust_outlier":
        oq, ot = _drift(q, t, rng, 0.001, 0.01)
        bad_q = np.asarray(jse3.exp_so3(jnp.asarray([0, 0, 2.0], jnp.float32)))
        loops = [(n - 1, 0, bad_q, np.array([30.0, -20.0, 5.0], np.float32))]
    else:
        oq, ot = _drift(q, t, rng)
        loops = _loops(q, t, n, 5)
        if scenario == "loop_chain_cg":
            cfg, cg_iters = dataclasses.replace(CFG, solver="chain_cg", **LOOPY), 128
        else:
            cfg = dataclasses.replace(CFG, solver="woodbury", wb_min_nodes=1, wb_cg_iters=8, **LOOPY)
    jg, tg = _build_both(cfg, oq, ot, loops, gps)
    assert tpg.uses_woodbury(128, 16, tconfig.PGOConfig(**dataclasses.asdict(cfg))) == (
        scenario == "loop_woodbury")
    _assert_graph(tg, jg, n)  # the appended graph itself
    jo, to = _optimize_both(cfg, jg, tg, cg_iters)
    _assert_graph(to, jo, n)
    if loops and scenario != "robust_outlier":
        ate = lambda p: np.sqrt(np.mean(np.sum((_np(p.trans)[:n] - t) ** 2, -1)))
        assert ate(to.poses) < 0.6 * ate(tg.poses)


def test_optimize_captured_graph_matches_reference():
    z = np.load(os.path.join(os.path.dirname(__file__), "data_pgo_regression_graph.npz"))
    tree = {
        "poses": {"quat": z["poses_q"], "trans": z["poses_t"]},
        "odom_poses": {"quat": z["odom_q"], "trans": z["odom_t"]},
        "n_nodes": z["n_nodes"], "odom_rel": {"quat": z["rel_q"], "trans": z["rel_t"]},
        "loop_i": z["loop_i"], "loop_j": z["loop_j"],
        "loop_rel": {"quat": z["loopr_q"], "trans": z["loopr_t"]},
        "n_loops": z["n_loops"], "gps_z": z["gps_z"], "gps_valid": z["gps_valid"],
        "chain_break": z["chain_break"],
    }
    jg = jpg.PoseGraph(**{k: (JPose(jnp.asarray(v["quat"]), jnp.asarray(v["trans"]))
                              if isinstance(v, dict) else jnp.asarray(v)) for k, v in tree.items()})
    tg = convert.graph_from_numpy(tree, CPU)
    n = int(z["n_nodes"])
    cfg = jconfig.kitti_hdl64().pgo
    jo = jpg.optimize(jg, cfg)
    to = tpg.optimize(tg, tconfig.kitti_hdl64().pgo)
    assert np.isfinite(to.poses.trans.numpy()).all()
    _assert_graph(to, jo, n)


def test_woodbury_step_matches_dense_oracle():
    """One Woodbury-preconditioned solve against the dense f64 solution of
    the same damped normal equations (tests/test_posegraph.py's oracle)."""
    rng = np.random.default_rng(0)
    n = 14
    q, t = _circle(n)
    oq, ot = _drift(q, t, rng)
    cfg = jconfig.PGOConfig(max_keyframes=16, max_loops=4)
    jg, tg = _build_both(cfg, oq, ot, [(n - 1, 0) + _rel(q, t, n - 1, 0)])
    tcfg = tconfig.PGOConfig(**dataclasses.asdict(cfg))
    N = 16
    free_np = (np.arange(N) > 0) & (np.arange(N) < n)
    tf = [tpg._sanitize(f) for f in tpg._linearize(tg, tcfg)]
    g, D, D_loop = tpg._gradient_and_diag(tf, N)
    free = torch.tensor(free_np)
    got = tpg._solve_woodbury(tf, g, D, D_loop, free, tcfg.lm_damping, iters=12).numpy()

    damp = tpg._damping(D, D_loop, tcfg.lm_damping)
    cols = []
    for idx in range(N * 6):
        e = torch.zeros((N, 6))
        e[idx // 6, idx % 6] = 1.0
        e[~free] = 0.0
        col = tpg._hess_matvec(tf, e, damp)
        col[~free] = 0.0
        cols.append(col.numpy().reshape(-1))
    H = np.stack(cols, axis=1).astype(np.float64)
    rows = np.repeat(free_np, 6)
    b = -g.numpy().reshape(-1).astype(np.float64)
    x = np.zeros(N * 6)
    x[rows] = np.linalg.solve(H[np.ix_(rows, rows)], b[rows])
    scale = max(1e-6, np.abs(x).max())
    assert np.abs(got.reshape(-1) - x).max() / scale < 5e-3


def test_graph_capacity_growth_keeps_contents():
    cfg = tconfig.PGOConfig(max_keyframes=64, max_loops=4)
    g = tpg.init_graph(cfg, CPU)
    quat = torch.tensor([1.0, 0, 0, 0])
    for k in range(300):
        g = tpg.add_keyframe(g, TPose(quat, torch.tensor([float(k), 0.0, 0.0])), 0.0, False,
                             n_nodes=k)
    assert tpg.node_capacity(g) >= 300 and int(g.n_nodes) == 300
    np.testing.assert_allclose(g.poses.trans.numpy()[:300, 0], np.arange(300), atol=1e-3)
    assert np.all(g.poses.trans.numpy()[300:] == 0.0)
    for k in range(20):
        g = tpg.add_loop(g, k + 1, 0, TPose(quat, torch.zeros(3)), n_loops=k)
    assert tpg.loop_capacity(g) >= 20 and int(g.n_loops) == 20
    np.testing.assert_array_equal(g.loop_i.numpy()[:20], np.arange(1, 21))
    g = tpg.optimize(g, cfg, cg_iters=8)
    assert np.isfinite(g.poses.trans.numpy()).all()
    with pytest.raises(ValueError):
        tpg.grow(g, node_capacity_new=32)
