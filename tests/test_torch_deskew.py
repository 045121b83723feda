"""The port's de-skew path and the remaining index / AoS variants against
the JAX reference, on the CPU.

- se3.quat_slerp and residuals.transform_points(s=), s = 0 and s = 1
  included; edge_factors_T / plane3_factors_T with s; the four AoS factor
  builders (and gn.normal_equations over them): every output within 1e-5
  (inputs O(1), the two frameworks evaluate in another order).
- correspond.ring_constrained_nn / nn2 on integer coordinates with planted
  ties (duplicated targets, equal distances across tiles): distances and
  indices exactly equal, ties to the lowest index.
- The sweep fractions (relative times) from the azimuth unwrap, equal to
  the compiled reference's bit for bit on streams that reach each of its
  branches.
- A 4-frame skewed drive (tests/test_deskew.py's scene at the reduced
  HDL-64 configuration) through features + odometry_step with distortion
  on: per-frame poses within 5e-4 (quaternion) / 5e-3 m and the
  republished clouds moved to the sweep's end within 5e-3 m; and each
  frame's step from the reference's own state
  (convert.odometry_state_from_numpy): its pose within 1e-5 m and the
  republished clouds within 5e-5 m. (That K2 entry A is not called there
  is pinned in tests/test_torch_frontend.py.)
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import odometry as jodo
from scaloam_tpu.ops import correspond as jcor, features as jfeat, gn as jgn
from scaloam_tpu.ops import residuals as jres, se3 as jse3
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.types import LidarScan as JScan, Pose as JPose
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import odometry as todo
from scaloam_tpu_torch.ops import correspond as tcor, features as tfeat, gn as tgn
from scaloam_tpu_torch.ops import residuals as tres, se3 as tse3
from scaloam_tpu_torch.ops.kernels import ring_azimuth
from scaloam_tpu_torch.types import LidarScan as TScan, Pose as TPose
from torch_threads import two_threads  # noqa: F401  (autouse)

ATOL = 1e-5
Q_TOL, T_TOL = 5e-4, 5e-3
# One de-skew step from the reference's state: the port ranks its 2-NN
# candidates as the reference does, so the solve agrees to rounding and the
# clouds moved to the sweep's end to a few float32 ulps at their range.
STEP_T_TOL, CLOUD_TOL = 1e-5, 5e-5


def _both(a):
    return jnp.asarray(a), torch.tensor(np.asarray(a))


def _pose(rng, rot=0.3, trans=1.0):
    w = rng.normal(0, rot, 3).astype(np.float32)
    q = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = rng.normal(0, trans, 3).astype(np.float32)
    return JPose(jnp.asarray(q), jnp.asarray(t)), TPose(torch.tensor(q), torch.tensor(t))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _fractions(rng, n):
    """Sweep fractions in [0, 1], both ends present."""
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[:2] = (0.0, 1.0)
    return s


def _case_quat_slerp(rng):
    q0 = rng.normal(size=(16, 4)).astype(np.float32)
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q1[:2] = q0[:2]  # equal ends: the small-angle branch
    s = _fractions(rng, 16)[:, None]
    return (jse3.quat_slerp(*map(jnp.asarray, (q0, q1, s))),
            tse3.quat_slerp(*map(torch.tensor, (q0, q1, s))))


def _case_transform_points_s(rng):
    jp, tp = _pose(rng)
    jx, tx = _both(rng.normal(0, 2, (32, 3)).astype(np.float32))
    js, ts = _both(_fractions(rng, 32))
    return jres.transform_points(jp, jx, s=js), tres.transform_points(tp, tx, s=ts)


def _edge_T(rng, n=24):
    p = rng.normal(size=(3, n)).astype(np.float32)
    a = p + rng.normal(0, 0.1, (3, n)).astype(np.float32)
    b = a + rng.normal(0, 0.3, (3, n)).astype(np.float32)
    return p, a, b, rng.uniform(size=n) < 0.8, _fractions(rng, n)


def _case_edge_factors_T_s(rng):
    jp, tp = _pose(rng, rot=0.05, trans=0.5)
    p, a, b, v, s = _edge_T(rng)
    return (jres.edge_factors_T(jp, *map(jnp.asarray, (p, a, b, v)), s=jnp.asarray(s)),
            tres.edge_factors_T(tp, *map(torch.tensor, (p, a, b, v)), s=torch.tensor(s)))


def _case_plane3_factors_T_s(rng):
    jp, tp = _pose(rng, rot=0.05, trans=0.5)
    n = 24
    p, j = (rng.normal(size=(3, n)).astype(np.float32) for _ in range(2))
    l = j + rng.normal(0, 0.5, (3, n)).astype(np.float32)
    m = j + rng.normal(0, 0.5, (3, n)).astype(np.float32)
    v, s = rng.uniform(size=n) < 0.8, _fractions(rng, n)
    return (jres.plane3_factors_T(jp, *map(jnp.asarray, (p, j, l, m, v)), s=jnp.asarray(s)),
            tres.plane3_factors_T(tp, *map(torch.tensor, (p, j, l, m, v)), s=torch.tensor(s)))


def _aos(rng, n=24):
    p = rng.normal(size=(n, 3)).astype(np.float32)
    a = p + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    c = a + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return p, a, b, c, nrm, rng.normal(0, 0.5, n).astype(np.float32), rng.uniform(size=n) < 0.8


def _case_edge_factors(rng):
    jp, tp = _pose(rng)
    p, a, b, _, _, _, v = _aos(rng)
    return (jres.edge_factors(jp, *map(jnp.asarray, (p, a, b, v))),
            tres.edge_factors(tp, *map(torch.tensor, (p, a, b, v))))


def _case_plane3_factors(rng):
    jp, tp = _pose(rng)
    p, a, b, c, _, _, v = _aos(rng)
    return (jres.plane3_factors(jp, *map(jnp.asarray, (p, a, b, c, v))),
            tres.plane3_factors(tp, *map(torch.tensor, (p, a, b, c, v))))


def _case_plane_norm_factors(rng):
    jp, tp = _pose(rng)
    p, _, _, _, nrm, nd, v = _aos(rng)
    return (jres.plane_norm_factors(jp, *map(jnp.asarray, (p, nrm, nd, v))),
            tres.plane_norm_factors(tp, *map(torch.tensor, (p, nrm, nd, v))))


def _case_distance_factors(rng):
    jp, tp = _pose(rng)
    p, a, _, _, _, _, v = _aos(rng)
    return (jres.distance_factors(jp, *map(jnp.asarray, (p, a, v))),
            tres.distance_factors(tp, *map(torch.tensor, (p, a, v))))


def _case_normal_equations_aos(rng):
    jp, tp = _pose(rng, rot=0.05, trans=0.2)
    p, a, b, c, nrm, nd, v = _aos(rng)
    j = [jres.edge_factors(jp, *map(jnp.asarray, (p, a, b, v))),
         jres.plane_norm_factors(jp, *map(jnp.asarray, (p, nrm, nd, v)))]
    t = [tres.edge_factors(tp, *map(torch.tensor, (p, a, b, v))),
         tres.plane_norm_factors(tp, *map(torch.tensor, (p, nrm, nd, v)))]
    return jgn.normal_equations(j, 0.1), tgn.normal_equations(t, 0.1)


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax(name, seed):
    want, got = (_leaves(x) for x in CASES[name](np.random.default_rng(seed)))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape, (name, w.shape, g.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("s_value", [0.0, 1.0])
def test_transform_points_at_sweep_ends(s_value):
    """s = 0 leaves the points, s = 1 applies the full pose, as in JAX."""
    jp, tp = _pose(np.random.default_rng(3))
    x = np.random.default_rng(4).normal(0, 5, (8, 3)).astype(np.float32)
    s = np.full(8, s_value, np.float32)
    got = tres.transform_points(tp, torch.tensor(x), s=torch.tensor(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(jres.transform_points(jp, jnp.asarray(x),
                                                                     s=jnp.asarray(s))),
                               atol=ATOL, rtol=0)
    want = x if s_value == 0.0 else tse3.apply(tp, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _tie_inputs(seed, Q=24, T=64):
    """Integer coordinates (|q|^2 + |t|^2 - 2 q.t is exact in f32) and
    duplicated targets, so equal distances occur within and across tiles."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, (T // 4, 3)).astype(np.float32)
    target = np.concatenate([base, base[::-1], base, base[::2].repeat(2, 0)])[:T]
    ring = rng.integers(0, 4, T).astype(np.float32)
    ring[T // 2:] = ring[: T // 2]  # duplicates keep their ring
    tmask = rng.uniform(size=T) < 0.9
    query = rng.integers(-3, 4, (Q, 3)).astype(np.float32)
    qmask = rng.uniform(size=Q) < 0.9
    ring_ref = rng.integers(0, 4, Q).astype(np.float32)
    excl = rng.integers(0, T, Q).astype(np.int32)
    return query, qmask, ring_ref, excl, target, tmask, ring


@pytest.mark.parametrize("fn", ["ring_constrained_nn", "ring_constrained_nn2"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_constrained_index_variants_match_jax_exactly(fn, seed):
    args = _tie_inputs(seed)
    want = getattr(jcor, fn)(*map(jnp.asarray, args), 1.0, tile=16)
    got = getattr(tcor, fn)(*map(torch.tensor, args), 1.0, tile=16)
    names = ("d_same", "i_same", "d_other", "i_other")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{fn} {name}")
    assert np.any(np.asarray(want[2]) < 1e29)  # some companions found


# ---------------------------------------------------------------------------
# the skewed drive
# ---------------------------------------------------------------------------


def _jcfg():
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=768,
            max_less_sharp=2048, max_flat=1536, max_less_flat=8192),
        odometry=dataclasses.replace(cfg.odometry, distortion=True),
    )


def _azimuth_stream(rng, unwrapped: bool, n=256):
    """A scan's stream of points whose azimuth sweeps from a random start
    through a random turn, with some noise: the unwrap's branches (end
    azimuth moved by -2 pi / +2 pi, second-half points moved by +2 pi) are
    all reached over a few dozen streams. `unwrapped`: a turn of more than
    pi that does not cross the -pi / pi seam (the end moved by -2 pi)."""
    if unwrapped:
        turn = rng.uniform(1.1 * np.pi, 1.6 * np.pi)
        start = rng.uniform(turn - 0.9 * np.pi, np.pi)
    else:
        start = rng.uniform(-np.pi, np.pi)
        turn = rng.uniform(0.5 * np.pi, 2.5 * np.pi)
    th = start - np.linspace(0.0, turn, n) + rng.normal(0, 0.05, n)
    r = rng.uniform(2.0, 60.0, n)
    return np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_relative_time_matches_compiled_reference_exactly(seed):
    """Sweep fractions (the de-skew's s) equal to the reference's bit for
    bit: its compiled code folds (a + 2 pi) +- 2 pi into a + (2 pi +- 2 pi),
    one rounding where an eager sum rounds twice."""
    rng = np.random.default_rng(seed)
    scalars, rel_at = jax.jit(jfeat._azimuth_scalars), jax.jit(jfeat._relative_time_at)
    taken = {"end-2pi": 0, "end+2pi": 0, "o2+2pi": 0}
    for i in range(48):
        xy = _azimuth_stream(rng, unwrapped=i % 4 == 0)
        n = xy.shape[0]
        xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], -1)
        valid = rng.uniform(size=n) > 0.05
        flip_valid = valid & (rng.uniform(size=n) > 0.05)
        js = [np.asarray(v) for v in scalars(jnp.asarray(xyz), jnp.asarray(valid),
                                              jnp.asarray(flip_valid))]
        ori_raw = ring_azimuth.ring_azimuth(torch.tensor(xyz), "HDL64", 64)[2]
        ts = tfeat._azimuth_scalars(ori_raw, torch.tensor(valid), torch.tensor(flip_valid))
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(t.numpy(), j)
        idx = rng.permutation(n).astype(np.int32)
        jr = np.asarray(rel_at(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]), jnp.asarray(idx), *js))
        tr = tfeat._relative_time_at(ori_raw, torch.tensor(idx), *ts)
        np.testing.assert_array_equal(tr.numpy(), jr)
        ori = -np.arctan2(xy[:, 1], xy[:, 0])
        first, last = np.argmax(valid), n - 1 - np.argmax(valid[::-1])
        d = ori[last] + 2 * np.pi - ori[first]
        taken["end-2pi"] += d > 3 * np.pi
        taken["end+2pi"] += d < np.pi
        taken["o2+2pi"] += bool(np.any(ori + 2 * np.pi < js[1] - 1.5 * np.pi))
    assert min(taken.values()) > 0, taken


@pytest.fixture
def pallas_interpret():
    orig = jsel.select_features

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jsel.select_features = interp
    yield
    jsel.select_features = orig


def test_deskew_drive_matches_reference(pallas_interpret):
    jcfg = _jcfg()
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=3), n_frames=4, speed=0.6, radius=30.0, n_azimuth=256,
        seed=10, skew=True, accel=0.25)
    js, ts = jodo.init_state(jcfg), todo.init_state(tcfg, "cpu")
    cap = jcfg.sensor.max_points
    for i, s in enumerate(scans):
        before = jax.tree.map(np.array, js)
        jf = jfeat.extract_features(JScan.from_numpy(s, cap), jcfg)
        tf = tfeat.extract_features(TScan.from_numpy(s, cap, "cpu"), tcfg)
        js, jo = jodo.odometry_step(js, jf, jcfg)
        ts, to = todo.odometry_step(ts, tf, tcfg)
        for what, g, w in (("rel", to.rel, jo.rel), ("world", to.world, jo.world)):
            q, wq = g.quat.numpy(), np.asarray(w.quat)
            q = q if np.dot(q, wq) >= 0 else -q
            np.testing.assert_allclose(q, wq, atol=Q_TOL, rtol=0, err_msg=f"frame {i} {what}")
            np.testing.assert_allclose(g.trans.numpy(), np.asarray(w.trans), atol=T_TOL, rtol=0,
                                       err_msg=f"frame {i} {what}")
        assert int(to.n_corner_corr) == pytest.approx(int(jo.n_corner_corr), abs=2)
        assert int(to.n_surf_corr) == pytest.approx(int(jo.n_surf_corr), abs=2)
        # the republished clouds are moved to the sweep's end, as there
        m = np.asarray(js.last_surf.mask)
        np.testing.assert_allclose(ts.last_surf.xyz.numpy()[m], np.asarray(js.last_surf.xyz)[m],
                                   atol=T_TOL, rtol=0)
        # The step from the reference's own state: the solve and the
        # republished clouds hold to STEP_T_TOL / CLOUD_TOL.
        ss, so = todo.odometry_step(convert.odometry_state_from_numpy(before, "cpu"), tf, tcfg)
        np.testing.assert_allclose(so.rel.trans.numpy(), np.asarray(jo.rel.trans), atol=STEP_T_TOL,
                                   rtol=0, err_msg=f"frame {i} rel from the shared state")
        for cloud in ("last_surf", "last_corner"):
            m = np.asarray(getattr(js, cloud).mask)
            np.testing.assert_array_equal(getattr(ss, cloud).mask.numpy(), m)
            np.testing.assert_allclose(getattr(ss, cloud).xyz.numpy()[m],
                                       np.asarray(getattr(js, cloud).xyz)[m], atol=CLOUD_TOL,
                                       rtol=0, err_msg=f"frame {i} {cloud}")
    assert np.linalg.norm(np.asarray(jo.rel.trans)) > 0.3  # the drive moved
