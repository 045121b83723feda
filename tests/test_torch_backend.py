"""The port's backend (scaloam_tpu_torch) against the JAX reference: the new
se3 functions, the index k-NN, ScanContext, ICP and the block-tridiagonal
solve, all on the CPU at small sizes (the pose graph: test_torch_posegraph.py).

Tolerances: se3 within 1e-5; k-NN indices equal (planted ties included);
ScanContext descriptors equal, distances within 1e-5 at the same shift;
blocktri within 1e-4 relative of the JAX solve and of a numpy f64 dense
solve; the Kabsch rotation (ops/kernels/kabsch.py, a fixed-sweep Jacobi)
within 1e-5 (Frobenius) of the reference's `jnp.linalg.svd` solve under
`jax.jit`; ICP quaternions within 1e-4 (sign aligned), translations within
1e-3 m, fitness within 1e-4, `converged` equal.
"""

import functools

import dataclasses

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import scancontext as jscm
from scaloam_tpu.ops import blocktri as jbt, gridmap as jgm, icp as jicp
from scaloam_tpu.ops import scancontext as jsc, se3 as jse3, voxel as jvox
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig
from scaloam_tpu_torch.models import scancontext as tscm
from scaloam_tpu_torch.ops import blocktri as tbt, gridmap as tgm, icp as ticp
from scaloam_tpu_torch.ops import scancontext as tsc, se3 as tse3, voxel as tvox
from scaloam_tpu_torch.ops.kernels import kabsch as tkabsch
from scaloam_tpu_torch.types import Pose as TPose
from torch_threads import two_threads  # noqa: F401  (autouse)

Q_TOL, T_TOL = 1e-4, 1e-3
CPU = "cpu"


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit_quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _assert_quat(got, want, tol, what=""):
    got, want = _np(got).reshape(-1, 4), _np(want).reshape(-1, 4)
    sign = np.where(np.sum(got * want, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, atol=tol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------


def _tangents(rng):
    xi = rng.normal(0, 0.6, (24, 6)).astype(np.float32)
    xi[:4, :3] *= 1e-6  # small-angle branches
    xi[4, :3] = 0.0
    return xi


def _se3_case(name, rng):
    q = _unit_quat(rng, 16)
    t = rng.normal(0, 2.0, (16, 3)).astype(np.float32)
    xi = _tangents(rng)
    if name == "hat":
        return jse3.hat(jnp.asarray(t)), tse3.hat(_t(t))
    if name == "log_so3":
        q[:2] = [[1, 0, 0, 0], [-1, 1e-7, 0, 0]]
        return jse3.log_so3(jnp.asarray(q)), tse3.log_so3(_t(q))
    if name == "left_jacobian":
        return (jse3._so3_left_jacobian(jnp.asarray(xi[:, :3])),
                tse3._so3_left_jacobian(_t(xi[:, :3])))
    if name == "left_jacobian_inv":
        return (jse3._so3_left_jacobian_inv(jnp.asarray(xi[:, :3])),
                tse3._so3_left_jacobian_inv(_t(xi[:, :3])))
    if name == "exp_se3":
        return tuple(jse3.exp_se3(jnp.asarray(xi))), tuple(tse3.exp_se3(_t(xi)))
    if name == "log_se3":
        return (jse3.log_se3(JPose(jnp.asarray(q), jnp.asarray(t))),
                tse3.log_se3(TPose(_t(q), _t(t))))
    if name == "relative":
        q2, t2 = _unit_quat(rng, 16), rng.normal(0, 2.0, (16, 3)).astype(np.float32)
        return (tuple(jse3.relative(JPose(jnp.asarray(q), jnp.asarray(t)),
                                    JPose(jnp.asarray(q2), jnp.asarray(t2)))),
                tuple(tse3.relative(TPose(_t(q), _t(t)), TPose(_t(q2), _t(t2)))))
    if name == "mat_to_quat":
        R = np.asarray(jse3.quat_to_mat(jnp.asarray(q)))
        return jse3.mat_to_quat(jnp.asarray(R)), tse3.mat_to_quat(_t(R))
    if name == "rpy_to_quat":
        rpy = rng.uniform(-3, 3, (3, 16)).astype(np.float32)
        return jse3.rpy_to_quat(*map(jnp.asarray, rpy)), tse3.rpy_to_quat(*map(_t, rpy))
    if name == "pose_to_matrix":
        return (jse3.pose_to_matrix(JPose(jnp.asarray(q), jnp.asarray(t))),
                tse3.pose_to_matrix(TPose(_t(q), _t(t))))
    if name == "matrix_to_pose":
        T = np.asarray(jse3.pose_to_matrix(JPose(jnp.asarray(q), jnp.asarray(t))))
        return tuple(jse3.matrix_to_pose(jnp.asarray(T))), tuple(tse3.matrix_to_pose(_t(T)))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "hat", "log_so3", "left_jacobian", "left_jacobian_inv", "exp_se3", "log_se3",
    "relative", "mat_to_quat", "rpy_to_quat", "pose_to_matrix", "matrix_to_pose",
])
def test_se3_function_matches_reference(name):
    want, got = _se3_case(name, np.random.default_rng(1))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=0, err_msg=name)


def test_log_se3_inverts_exp_se3():
    xi = _tangents(np.random.default_rng(2))
    back = tse3.log_se3(tse3.exp_se3(_t(xi)))
    np.testing.assert_allclose(back.numpy(), xi, atol=1e-5, rtol=0)


def test_batched_identity():
    p = TPose.identity(CPU, (3, 2))
    assert p.quat.shape == (3, 2, 4) and p.trans.shape == (3, 2, 3)
    np.testing.assert_array_equal(p.quat.numpy()[..., 0], 1.0)
    assert float(p.quat[..., 1:].abs().sum() + p.trans.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# index k-NN
# ---------------------------------------------------------------------------


def _tie_cloud(rng, n_q=96, n_t=512):
    """Targets on a 0.5 m lattice with duplicates (exact distance ties),
    queries on lattice points and cell centres, some masks off."""
    tgt = rng.integers(-4, 5, (n_t, 3)).astype(np.float32) * 0.5
    tgt[n_t // 2:] = tgt[: n_t // 2]  # every target twice
    qry = rng.integers(-4, 5, (n_q, 3)).astype(np.float32) * 0.5
    qry[::3] += 0.25
    tm = rng.uniform(size=n_t) < 0.85
    qm = rng.uniform(size=n_q) < 0.9
    return qry, qm, tgt, tm


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_knn_indices_match_reference_with_ties(k):
    qry, qm, tgt, tm = _tie_cloud(np.random.default_rng(k))
    jd, ji = jvox.knn(*map(jnp.asarray, (qry, qm, tgt, tm)), k=k, tile=128)
    td, ti = tvox.knn(*map(_t, (qry, qm, tgt, tm)), k=k, tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def test_nn1_and_pad_to_multiple_match_reference():
    qry, qm, tgt, tm = _tie_cloud(np.random.default_rng(9), n_t=500)
    jt, jm = jvox.pad_to_multiple(jnp.asarray(tgt), jnp.asarray(tm), 128)
    tt, tmm = tvox.pad_to_multiple(_t(tgt), _t(tm), 128)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tmm.numpy(), np.asarray(jm))
    jd, ji = jvox.nn1(jnp.asarray(qry), jnp.asarray(qm), jt, jm, tile=128)
    td, ti = tvox.nn1(_t(qry), _t(qm), tt, tmm, tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# ScanContext
# ---------------------------------------------------------------------------


def _scan(seed, pos, yaw):
    world = synthetic.make_world(seed=7)
    return synthetic.simulate_scan(world, np.array(pos), yaw, n_azimuth=600, seed=seed)


def _desc_both(pts, mask=None):
    mask = np.ones(len(pts), bool) if mask is None else mask
    return (jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask)),
            tsc.make_descriptor(_t(pts), _t(mask)))


def test_descriptor_equals_reference():
    pts = _scan(1, [0.0, 0.0, 1.8], 0.2)
    pts[::7, 2] = -5.0  # bins whose max z is negative stay negative
    mask = np.random.default_rng(0).uniform(size=len(pts)) < 0.9
    want, got = _desc_both(pts, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) < 0).any()
    np.testing.assert_allclose(tsc.ring_key(got).numpy(), np.asarray(jsc.ring_key(want)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("pose2", [([1.5, 0.5, 1.8], 0.6), ([0.0, 0.0, 1.8], np.deg2rad(60))])
def test_sc_distance_matches_reference(pose2):
    j1, t1 = _desc_both(_scan(1, [0.0, 0.0, 1.8], 0.0))
    j2, t2 = _desc_both(_scan(2, *pose2))
    jd, js = jsc.sc_distance(j1, j2)
    td, ts = tsc.sc_distance(t1, t2)
    assert int(ts) == int(js)
    assert abs(float(td) - float(jd)) < 1e-5


def test_ring_key_knn_breaks_ties_to_lower_index():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 3, (40, 20)).astype(np.float32)
    keys[20:] = keys[:20]
    valid = np.arange(40) < 37
    q = keys[5] + 0.5
    jv, ji = jsc.ring_key_knn(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(valid), 10)
    tv, ti = tsc.ring_key_knn(_t(q), _t(keys), _t(valid), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def _sc_cfgs(**kw):
    j = jconfig.ScanContextConfig(num_exclude_recent=3, num_candidates=3, max_keyframes=64, **kw)
    return j, tconfig.ScanContextConfig(**dataclasses.asdict(j))


def test_loop_detection_scene_matches_reference():
    """tests/test_scancontext.py's drive: places 0..9, then place 0 again."""
    jc, tc = _sc_cfgs(dist_threshold=0.4)
    jm, tm = jscm.SCManager(jc), tscm.SCManager(tc, CPU)
    scans = [_scan(i, [3.0 * i, 0.0, 1.8], 0.1 * i) for i in range(10)]
    scans.append(_scan(99, [0.3, 0.1, 1.8], 0.8))
    for pts in scans:
        ones = np.ones(len(pts), bool)
        jm.make_and_save(jnp.asarray(pts), jnp.asarray(ones))
        tm.make_and_save(_t(pts), _t(ones))
        ji, jy, jd = jm.detect_loop_closure_id()
        ti, ty, td = tm.detect_loop_closure_id()
        assert ti == ji and abs(ty - jy) < 1e-6
        assert (td == jd) or abs(td - jd) < 1e-5
    assert ti == 0
    np.testing.assert_array_equal(tm.db.descriptors.numpy()[:11],
                                  np.asarray(jm.db.descriptors)[:11])


def test_between_session_detection_matches_reference():
    jc, tc = _sc_cfgs()
    jm, tm = jscm.SCManager(jc), tscm.SCManager(tc, CPU)
    for i in range(6):
        pts = _scan(i, [4.0 * i, 0.0, 1.8], 0.2 * i)
        ones = np.ones(len(pts), bool)
        jm.make_and_save(jnp.asarray(pts), jnp.asarray(ones))
        tm.make_and_save(_t(pts), _t(ones))
    want_q, got_q = _desc_both(_scan(50, [8.0, 0.2, 1.8], 1.0))
    ji, jy, jd = jm.detect_between_session(want_q)
    ti, ty, td = tm.detect_between_session(got_q)
    assert ti == ji == 2
    assert abs(ty - jy) < 1e-6 and abs(td - jd) < 1e-5


def test_sc_db_grows_past_capacity():
    tc = tconfig.ScanContextConfig(max_keyframes=8, num_exclude_recent=2)
    mgr = tscm.SCManager(tc, CPU)
    descs = np.random.default_rng(0).uniform(0, 5, (40, 20, 60)).astype(np.float32)
    for d in descs:
        mgr.save_descriptor(_t(d))
    assert mgr.db.descriptors.shape[0] >= 40 and int(mgr.db.count) == 40
    np.testing.assert_array_equal(mgr.db.descriptors.numpy()[:40], descs)
    np.testing.assert_allclose(mgr.db.ring_keys.numpy()[:40], descs.mean(-1), atol=1e-6)


# ---------------------------------------------------------------------------
# blocktri
# ---------------------------------------------------------------------------


def _chain_system(rng, n, r=None):
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    D = np.einsum("nij,nkj->nik", A, A) + 6.0 * np.eye(6, dtype=np.float32)
    B = 0.4 * rng.normal(size=(n, 6, 6)).astype(np.float32)
    B[-1] = 0.0
    b = rng.normal(size=(n, 6) if r is None else (n, 6, r)).astype(np.float32)
    return D, B, b


def _dense(D, B):
    n = D.shape[0]
    H = np.zeros((6 * n, 6 * n))
    for i in range(n):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
        if i + 1 < n:
            H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = B[i]
            H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = B[i].T
    return H


@pytest.mark.parametrize("n,r", [(1, None), (13, None), (32, None), (21, 5)])
def test_blocktri_solve_matches_reference_and_dense(n, r):
    D, B, b = _chain_system(np.random.default_rng(n), n, r)
    want = np.asarray(jbt.solve(jbt.factor(jnp.asarray(D), jnp.asarray(B), reg=0.0),
                                jnp.asarray(b)))
    got = tbt.solve(tbt.factor(_t(D), _t(B), reg=0.0), _t(b)).numpy()
    x = np.linalg.solve(_dense(D.astype(np.float64), B.astype(np.float64)),
                        b.reshape(6 * n, -1).astype(np.float64)).reshape(b.shape)
    scale = np.abs(x).max()
    assert np.abs(got - want).max() / scale < 1e-4
    assert np.abs(got - x).max() / scale < 1e-4
    # the default per-level floor, as the preconditioner uses it
    want_r = np.asarray(jbt.solve(jbt.factor(jnp.asarray(D), jnp.asarray(B)), jnp.asarray(b)))
    got_r = tbt.solve(tbt.factor(_t(D), _t(B)), _t(b)).numpy()
    assert np.abs(got_r - want_r).max() / np.abs(want_r).max() < 1e-4


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------


@jax.jit
@functools.partial(jax.vmap)
def _reference_kabsch(H):
    """The rotation of the reference's ICP step (scaloam_tpu/ops/icp.py:122-126)."""
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=jax.lax.Precision.HIGHEST)))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(d)
    return Vt.T @ D @ U.T


def _kabsch_inputs(case, n=300):
    """n matrices H [n, 3, 3] of one kind: Gaussian entries at scales from
    0.1 to 1e4; near-planar (s3 = 1e-6 s1); det < 0 (the sign fix flips the
    smallest direction); rank 2 (s3 = 0); and H = 0 (no point matched).
    The reflected singular values are kept 0.1 s1 apart: with det < 0 the
    rotation moves by 1/(s2 - s3) per unit of rounding, so where s2 and s3
    nearly meet float32 LAPACK itself departs from a float64 solve by more
    than the tolerance."""
    rng = np.random.default_rng(len(case))
    if case == "zero":
        return np.zeros((8, 3, 3), np.float32)
    if case == "random":
        return (rng.normal(size=(n, 3, 3)) * rng.uniform(0.1, 1e4, (n, 1, 1))).astype(np.float32)
    U, V = (np.linalg.qr(rng.normal(size=(n, 3, 3)))[0] for _ in range(2))
    s = np.sort(rng.uniform(0.1, 1.0, (n, 3)), axis=1)[:, ::-1] * rng.uniform(1, 1e3, (n, 1))
    if case == "reflected":
        s = s[:, :1] * np.array([1.0, 0.6, 0.2]) * rng.uniform(0.8, 1.0, (n, 3))
        s = np.sort(s, axis=1)[:, ::-1]
    s[:, 2] = {"planar": 1e-6 * s[:, 0], "rank2": 0.0}.get(case, s[:, 2])
    H = U @ (s[:, :, None] * np.swapaxes(V, 1, 2))
    if case == "reflected":
        H *= np.where(np.linalg.det(H) > 0, -1.0, 1.0)[:, None, None]
    return H.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "planar", "reflected", "rank2", "zero"])
def test_kabsch_rotation_matches_reference(case):
    H = _kabsch_inputs(case)
    want = np.asarray(_reference_kabsch(jnp.asarray(H)))
    got = tkabsch.kabsch_rotation(torch.from_numpy(H)).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want, axis=(1, 2)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    if case == "reflected":
        assert (np.linalg.det(H) < 0).all()


def _icp_clouds(rng, n_tgt, n_src, w, t):
    tgt = rng.uniform(-20, 20, (n_tgt, 3)).astype(np.float32)
    tgt[:, 2] *= 0.2
    C = JPose(jse3.exp_so3(jnp.asarray(w, jnp.float32)), jnp.asarray(t, jnp.float32))
    src = np.asarray(jse3.apply(jse3.inverse(C), jnp.asarray(tgt[:n_src])))
    src = src + rng.normal(0, 0.01, src.shape).astype(np.float32)
    return tgt, src


def _assert_icp(got, want):
    _assert_quat(got.transform.quat, want.transform.quat, Q_TOL, "quat")
    np.testing.assert_allclose(_np(got.transform.trans), np.asarray(want.transform.trans),
                               atol=T_TOL, rtol=0)
    np.testing.assert_allclose(_np(got.fitness), np.asarray(want.fitness), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_np(got.converged), np.asarray(want.converged))


def test_icp_point2point_matches_reference():
    rng = np.random.default_rng(4)
    tgt, src = _icp_clouds(rng, 1024, 256, [0.0, 0.0, 0.1], [0.6, -0.4, 0.1])
    sm, tm = rng.uniform(size=256) < 0.95, rng.uniform(size=1024) < 0.95
    init_q = np.stack([[1.0, 0, 0, 0], [np.cos(0.05), 0, 0, np.sin(0.05)]]).astype(np.float32)
    init_t = np.zeros((2, 3), np.float32)
    for b in range(2):
        want = jicp.icp_point2point(*map(jnp.asarray, (src, sm, tgt, tm)),
                                    JPose(jnp.asarray(init_q[b]), jnp.asarray(init_t[b])),
                                    iterations=12)
        got = ticp.icp_point2point(*map(_t, (src, sm, tgt, tm)),
                                   TPose(_t(init_q[b]), _t(init_t[b])), iterations=12)
        _assert_icp(got, want)
        # the batched seeds give each seed's own result
        both = ticp.icp_point2point(*map(_t, (src, sm, tgt, tm)),
                                    TPose(_t(init_q), _t(init_t)), iterations=12)
        _assert_quat(both.transform.quat[b], got.transform.quat, 1e-6)
        assert float(both.fitness[b]) == pytest.approx(float(got.fitness), abs=1e-6)


def _grids(tgt, G, cell, dedup):
    jg = jgm.insert(jgm.init_grid(G ** 3, 32), jnp.asarray(tgt), jnp.ones(len(tgt), bool),
                    G, G, G, cell, dedup)
    tg = tgm.insert(tgm.init_grid(G ** 3, 32, CPU), _t(tgt), torch.ones(len(tgt), dtype=torch.bool),
                    G, G, G, cell, dedup)
    return jg, tg


def test_icp_point2point_grid_matches_reference():
    rng = np.random.default_rng(5)
    tgt, src = _icp_clouds(rng, 4096, 1024, [0.0, 0.0, 0.08], [0.8, -0.5, 0.2])
    jg, tg = _grids(tgt, 16, 4.0, 0.05)
    sm = np.ones(len(src), bool)
    want = jicp.icp_point2point_grid(jnp.asarray(src), jnp.asarray(sm), jg, 16, 16, 16, 4.0, 4.0,
                                     JPose.identity(), iterations=15)
    got = ticp.icp_point2point_grid(_t(src), _t(sm), tg, 16, 16, 16, 4.0, 4.0,
                                    TPose.identity(CPU), iterations=15)
    _assert_icp(got, want)
    assert float(got.fitness) < 0.05


def test_verify_loop_matches_reference():
    rng = np.random.default_rng(6)
    tgt, src = _icp_clouds(rng, 4096, 2048, [0.0, 0.0, 0.15], [1.2, 0.4, 0.0])
    pad = np.zeros((4096, 3), np.float32)
    pad[: len(tgt)] = tgt
    pm = np.ones(4096, bool)
    sm = np.ones(len(src), bool)
    c_src, c_tgt = src[::8].copy(), tgt[::4].copy()
    inits_q = np.stack([[1.0, 0, 0, 0], [np.cos(-0.05), 0, 0, np.sin(-0.05)]]).astype(np.float32)
    inits_t = np.zeros((2, 3), np.float32)
    kw = dict(voxel_size=0.4, sub_capacity=4096, gx=16, gy=16, gz=16, cell_size=2.0,
              cell_cap=32, dedup_radius=0.4, reach=2.0, max_corr_dist=150.0,
              coarse_iterations=12, fine_iterations=10, transformation_eps=1e-6)
    want, wfit = jicp.verify_loop(
        jnp.asarray(src), jnp.asarray(sm), jnp.asarray(c_src), jnp.ones(len(c_src), bool),
        jnp.asarray(c_tgt), jnp.ones(len(c_tgt), bool), jnp.asarray(pad), jnp.asarray(pm),
        JPose(jnp.asarray(inits_q), jnp.asarray(inits_t)), **kw)
    got, gfit = ticp.verify_loop(
        _t(src), _t(sm), _t(c_src), torch.ones(len(c_src), dtype=torch.bool),
        _t(c_tgt), torch.ones(len(c_tgt), dtype=torch.bool), _t(pad), _t(pm),
        TPose(_t(inits_q), _t(inits_t)), **kw)
    np.testing.assert_allclose(gfit.numpy(), np.asarray(wfit), atol=1e-4, rtol=0)
    _assert_icp(got, want)
    assert bool(got.converged)
