"""PyTorch port vs JAX reference: se3, fit, gn and residuals.

Each case feeds the same numpy inputs (made from a seed) through the JAX
function and its scaloam_tpu_torch counterpart on the CPU and compares
every output leaf at atol 1e-5 (inputs are O(1), so this is ~100 f32 ulps
of slack for the different evaluation order of the two frameworks)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scaloam_tpu.ops import fit as jfit, gn as jgn, residuals as jres, se3 as jse3
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu_torch.ops import fit as tfit, gn as tgn, residuals as tres, se3 as tse3
from scaloam_tpu_torch.types import Pose as TPose
from torch_threads import two_threads  # noqa: F401  (autouse)

ATOL = 1e-5


def _unit_quat(rng, n=None):
    q = rng.normal(size=(4,) if n is None else (n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pose(rng):
    q = _unit_quat(rng)
    t = rng.normal(0, 0.5, 3).astype(np.float32)
    return (JPose(jnp.asarray(q), jnp.asarray(t)), TPose(torch.tensor(q), torch.tensor(t)))


def _both(a):
    return jnp.asarray(a), torch.tensor(np.asarray(a))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _case_quat_mul(rng):
    a, b = _unit_quat(rng, 16), _unit_quat(rng, 16)
    return jse3.quat_mul(*map(jnp.asarray, (a, b))), tse3.quat_mul(torch.tensor(a), torch.tensor(b))


def _case_quat_conj(rng):
    ja, ta = _both(_unit_quat(rng, 8))
    return jse3.quat_conj(ja), tse3.quat_conj(ta)


def _case_quat_to_mat(rng):
    ja, ta = _both(_unit_quat(rng, 8))
    return jse3.quat_to_mat(ja), tse3.quat_to_mat(ta)


def _case_exp_so3(rng):
    w = rng.normal(0, 0.5, (16, 3)).astype(np.float32)
    w[:4] *= 1e-7  # the small-angle branch
    jw, tw = _both(w)
    return jse3.exp_so3(jw), tse3.exp_so3(tw)


def _case_compose(rng):
    (ja, ta), (jb, tb) = _pose(rng), _pose(rng)
    return jse3.compose(ja, jb), tse3.compose(ta, tb)


def _case_inverse(rng):
    jp, tp = _pose(rng)
    return jse3.inverse(jp), tse3.inverse(tp)


def _case_apply(rng):
    jp, tp = _pose(rng)
    jx, tx = _both(rng.normal(size=(32, 3)).astype(np.float32))
    return jse3.apply(jp, jx), tse3.apply(tp, tx)


def _case_quat_to_rpy(rng):
    ja, ta = _both(_unit_quat(rng, 16))
    return jse3.quat_to_rpy(ja), tse3.quat_to_rpy(ta)


def _sym(rng, n, flat=False):
    pts = rng.normal(size=(n, 5, 3)).astype(np.float32)
    if flat:
        pts[..., 2] *= 0.01
    d = pts - pts.mean(1, keepdims=True)
    return np.einsum("nki,nkj->nij", d, d) / 5, pts


def _case_eigh3x3(rng):
    ja, ta = _both(_sym(rng, 64)[0])
    return jfit.eigh3x3(ja), tfit.eigh3x3(ta)


def _case_neighborhood_cov(rng):
    jp, tp = _both(_sym(rng, 32)[1])
    return jfit.neighborhood_cov(jp), tfit.neighborhood_cov(tp)


def _case_fit_plane(rng):
    pts = _sym(rng, 64, flat=True)[1] + np.float32(0.5)
    pts[:4] = pts[:4, :1]  # degenerate (coincident) neighborhoods
    jp, tp = _both(pts)
    return jfit.fit_plane(jp), tfit.fit_plane(tp)


def _case_huber_weight(rng):
    js, ts = _both(np.abs(rng.normal(0, 0.2, 64)).astype(np.float32))
    return jgn.huber_weight(js, 0.1), tgn.huber_weight(ts, 0.1)


def _edge_inputs(rng, n=48):
    p = rng.normal(size=(3, n)).astype(np.float32)
    a = p + rng.normal(0, 0.1, (3, n)).astype(np.float32)
    b = a + rng.normal(0, 0.3, (3, n)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    return p, a, b, valid


def _plane_inputs(rng, n=48):
    p = rng.normal(size=(3, n)).astype(np.float32)
    nrm = rng.normal(size=(3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    nd = rng.normal(0, 0.5, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    return p, nrm, nd, valid


def _case_transform_points(rng):
    jp, tp = _pose(rng)
    jx, tx = _both(rng.normal(size=(32, 3)).astype(np.float32))
    return jres.transform_points(jp, jx), tres.transform_points(tp, tx)


def _case_edge_prep_T(rng):
    args = _edge_inputs(rng)
    return jres.edge_prep_T(*map(jnp.asarray, args)), tres.edge_prep_T(*map(torch.tensor, args))


def _case_edge_factors_from_prep(rng):
    args = _edge_inputs(rng)
    jp, tp = _pose(rng)
    return (jres.edge_factors_from_prep(jp, jres.edge_prep_T(*map(jnp.asarray, args))),
            tres.edge_factors_from_prep(tp, tres.edge_prep_T(*map(torch.tensor, args))))


def _case_plane3_prep_T(rng):
    j, l, m = (rng.normal(size=(3, 40)).astype(np.float32) for _ in range(3))
    return jres.plane3_prep_T(*map(jnp.asarray, (j, l, m))), tres.plane3_prep_T(*map(torch.tensor, (j, l, m)))


def _case_plane_norm_factors_T(rng):
    args = _plane_inputs(rng)
    jp, tp = _pose(rng)
    return (jres.plane_norm_factors_T(jp, *map(jnp.asarray, args)),
            tres.plane_norm_factors_T(tp, *map(torch.tensor, args)))


def _factor_sets(rng, jp, tp):
    e, pl = _edge_inputs(rng), _plane_inputs(rng)
    js = [jres.edge_factors_from_prep(jp, jres.edge_prep_T(*map(jnp.asarray, e))),
          jres.plane_norm_factors_T(jp, *map(jnp.asarray, pl))]
    ts = [tres.edge_factors_from_prep(tp, tres.edge_prep_T(*map(torch.tensor, e))),
          tres.plane_norm_factors_T(tp, *map(torch.tensor, pl))]
    return js, ts


def _case_normal_equations(rng):
    js, ts = _factor_sets(rng, *_pose(rng))
    return jgn.normal_equations(js, 0.1), tgn.normal_equations(ts, 0.1)


def _spd(rng):
    m = rng.normal(size=(6, 6)).astype(np.float32)
    return m @ m.T + np.eye(6, dtype=np.float32), rng.normal(size=6).astype(np.float32)


def _case_cholesky_solve6(rng):
    A, b = _spd(rng)
    return jgn.cholesky_solve6(jnp.asarray(A), jnp.asarray(b)), tgn.cholesky_solve6(torch.tensor(A), torch.tensor(b))


def _case_solve_step(rng):
    A, b = _spd(rng)
    return jgn.solve_step(jnp.asarray(A), jnp.asarray(b)), tgn.solve_step(torch.tensor(A), torch.tensor(b))


def _case_apply_delta(rng):
    jp, tp = _pose(rng)
    jd, td = _both(rng.normal(0, 0.05, 6).astype(np.float32))
    return jgn.apply_delta(jp, jd), tgn.apply_delta(tp, td)


def _case_gauss_newton(rng):
    """Point-to-plane alignment of a small cloud, 4 iterations from identity."""
    p, nrm, _, valid = _plane_inputs(rng, 96)
    _, tgt = _pose(rng)
    tw = tse3.apply(TPose(tgt.quat, tgt.trans * 0.2), torch.tensor(p.T)).numpy().T
    nd = -np.sum(nrm * tw, axis=0)
    jargs = tuple(map(jnp.asarray, (p, nrm, nd, valid)))
    targs = tuple(map(torch.tensor, (p, nrm, nd, valid)))
    j0 = JPose(jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32))
    t0 = TPose(torch.tensor([1.0, 0, 0, 0]), torch.zeros(3))
    return (jgn.gauss_newton(j0, lambda q: [jres.plane_norm_factors_T(q, *jargs)], 4, 0.1),
            tgn.gauss_newton(t0, lambda q: [tres.plane_norm_factors_T(q, *targs)], 4, 0.1))


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax(name, seed):
    rng = np.random.default_rng(seed)
    want, got = CASES[name](rng)
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape, (name, w.shape, g.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_atan2_rounds_like_the_reference():
    """f32.atan2 equals the compiled reference's atan2 (the C library's
    atan2f) bit for bit in every quadrant, on the axes and at signed
    zeros; torch.atan2 rounds otherwise in a fifth of these cases."""
    import jax

    from scaloam_tpu_torch.ops import f32

    rng = np.random.default_rng(3)
    y = rng.uniform(-100, 100, 20000).astype(np.float32)
    x = rng.uniform(-100, 100, 20000).astype(np.float32)
    y[:100], x[100:200], y[200:300], x[300:400] = 0.0, 0.0, -0.0, 1.0
    y[400:500] *= 1e-4
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = f32.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_f32_rounds_once_like_the_compiled_reference():
    """f32.fma_f32 is one float32 rounding of a * b + c, as XLA's
    contracted multiply-add: on sums whose float64 rounding lands on a
    float32 tie the exact sum is not on (rounding to nearest twice would
    take the tie's even side) and on random triples, equal to the compiled
    reference's a * b + c bit for bit."""
    import jax

    from scaloam_tpu_torch.ops import f32

    e = 2.0 ** -23
    a = np.array([1 + e, 1 + e, -(1 + e), 1 + e], np.float32)
    b = np.array([1 - e, 1 - e, 1 - e, 1 + e], np.float32)
    c = np.array([2**24 + 2, 2**24 + 4, -(2**24 + 2), 2**24], np.float32)
    # a * b just off half an ulp of c: the float64 sum lands on the tie
    rng = np.random.default_rng(5)
    n = 20000
    k = rng.integers(0, 30, n)
    tie_c = (np.ldexp(1.0, k + 23) + np.ldexp(2.0 * rng.integers(1, 2**20, n) + 1, k))
    tie_a = (1 + np.ldexp(rng.integers(1, 200, n), -23)) * np.ldexp(1.0, k - 1)
    tie_a *= rng.choice([1.0, -1.0], n)
    tie_b = 1 - np.ldexp(rng.integers(1, 200, n), -23)
    a, b, c = (np.concatenate([v, w, rng.uniform(-50, 50, 4000)]).astype(np.float32)
               for v, w in ((a, tie_a), (b, tie_b), (c, tie_c)))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = f32.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got[:4], [2**24 + 2, 2**24 + 4, -(2**24 + 2), 2**24 + 2])


def test_rounding_ops_on_the_cpu_are_the_plain_versions_under_vmap():
    """kernels.f32ops on CPU tensors runs ops/f32.py's plain versions,
    also under torch.func.vmap (no per-sample fallback) with an unbatched
    argument; on the card the same calls launch csrc/f32ops.cu."""
    import warnings

    from scaloam_tpu_torch.ops import f32
    from scaloam_tpu_torch.ops.kernels import f32ops

    rng = np.random.default_rng(6)
    pts = torch.tensor(rng.uniform(-60, 60, (2, 300, 3)), dtype=torch.float32)
    yx = torch.tensor(rng.uniform(-10, 10, (2, 500)), dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = torch.func.vmap(f32ops.sq_dist, in_dims=(0, None))(pts, pts[1, :50])
        n = torch.func.vmap(f32ops.sum3_sq)(pts)
        t = torch.func.vmap(f32ops.atan2, in_dims=(0, None))(yx, yx[1])
    for b in range(2):
        assert torch.equal(d[b], f32.sq_dist(pts[b], pts[1, :50]))
        assert torch.equal(n[b], f32.sum3_sq(pts[b]))
        assert torch.equal(t[b], f32.atan2(yx[b], yx[1]))
    assert f32ops.sq_dist.launches == f32ops.sum3_sq.launches == f32ops.atan2.launches == 0
