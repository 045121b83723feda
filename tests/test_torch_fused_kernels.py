"""The two fused kernels' plain versions on the CPU: the pose graph's
Hessian-vector product (ops/kernels/hess_matvec.py, one launch a CG step
on the card) and ICP's weighted-Kabsch step (ops/kernels/kabsch.py
`kabsch_step`, one launch an ICP iteration).

Tolerances:
- the matvec against the JAX reference's `_hess_matvec` (masked as its
  CG masks it): within 1e-5 of the largest entry (float32 products summed
  in another order; the odometry weights reach 1e6);
- the matvec against the port's former composition
  (`chip_smoke.former_matvec`: einsums, shifts, the fixed-order segment
  sums, the two masks): equal, since the CPU's einsum sums the six terms
  of a product from the first, as the plain version;
- the step against one step of the reference's `icp_point2point` on the
  same correspondences: quaternion within 2e-6, translation within 2e-5 m;
  against a float64 Kabsch (numpy's SVD): quaternion within 1e-5,
  translation within 1e-4 m over clouds of ~10 m;
- the step's rotation equals `kabsch_plain` on the H it computes, bit for
  bit; the plain versions' square roots are correctly rounded.
"""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import posegraph as jpg
from scaloam_tpu.ops import icp as jicp, se3 as jse3, voxel as jvoxel
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu_torch import config as tconfig
from scaloam_tpu_torch.models import posegraph as tpg
from scaloam_tpu_torch.ops import f32, se3 as tse3
from scaloam_tpu_torch.ops.kernels import hess_matvec, kabsch
from scaloam_tpu_torch.types import Pose as TPose
from kabsch_reference import F64_Q_TOL, F64_T_TOL
from kabsch_reference import f64_kabsch as _f64_kabsch, quat_err as _quat_err
from torch_threads import two_threads  # noqa: F401  (autouse)

MV_REL_TOL = 1e-5
STEP_Q_TOL, STEP_T_TOL = 2e-6, 2e-5


# ---------------------------------------------------------------- matvec

MV_CFG = jconfig.PGOConfig(max_keyframes=64, max_loops=16, loop_variance=1e-3)
MV_N, MV_L = 64, 16  # one capacity for every case: the reference compiles once


def _graph(n, pairs, gps_every=0, seed=3):
    """The port's graph of n drifted circle nodes (capacity MV_N) with the
    loops `pairs` and a GPS altitude on every gps_every-th node, and the
    same graph as the reference's PoseGraph."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(n) / n
    q = np.asarray(jse3.rpy_to_quat(jnp.zeros(n), jnp.zeros(n), jnp.asarray(th, jnp.float32)))
    t = np.stack([20 * np.sin(th), 20 * (1 - np.cos(th)), 0.1 * np.arange(n)], -1)
    t = (t + rng.normal(0, 0.05, t.shape)).astype(np.float32)
    tg = tpg.init_graph(tconfig.PGOConfig(**dataclasses.asdict(MV_CFG)), "cpu",
                        initial_nodes=MV_N, initial_loops=MV_L)
    for k in range(n):
        gps = bool(gps_every) and k % gps_every == 0
        z = np.float32(t[k, 2] + 0.3 if gps else 0.0)
        tg = tpg.add_keyframe(tg, TPose(torch.tensor(q[k]), torch.tensor(t[k])), z, gps,
                              n_nodes=k)
    for m, (i, j) in enumerate(pairs):
        r = jse3.relative(JPose(jnp.asarray(q[i]), jnp.asarray(t[i])),
                          JPose(jnp.asarray(q[j]), jnp.asarray(t[j])))
        zq, zt = np.asarray(r.quat), np.asarray(r.trans) + rng.normal(0, 0.1, 3).astype(np.float32)
        tg = tpg.add_loop(tg, i, j, TPose(torch.tensor(zq), torch.tensor(zt)), n_loops=m)
    leaf = lambda x: (JPose(jnp.asarray(x.quat.numpy()), jnp.asarray(x.trans.numpy()))
                      if isinstance(x, TPose) else jnp.asarray(x.numpy()))
    jg = jpg.PoseGraph(**{k: leaf(x) for k, x in tg._asdict().items()})
    return jg, tg


@jax.jit
def _reference_matvec(jg, v, damp, free):
    """The reference's CG matvec, masked as its _run_pcg masks it."""
    factors = [jpg._sanitize(f) for f in jpg._linearize(jg, MV_CFG)]
    fm = free[:, None]
    return jnp.where(fm, jpg._hess_matvec(factors, jnp.where(fm, v, 0.0), damp), 0.0)


SHARED = [(23, 0), (22, 0), (23, 1), (20, 0), (23, 5), (21, 1), (5, 23)]  # shared ends
CASES = {  # (nodes, loops, GPS every k-th node)
    "shared_loops_gps_padding": (24, SHARED, 3),
    "no_loops": (24, [], 0),
    "full_capacity": (64, SHARED + [(63, 0), (62, 63)], 4),
    "one_block_edge": (33, [(32, 0), (31, 32), (32, 1), (32, 31)], 2),
}


def _port_inputs(tg, seed=4):
    tcfg = tconfig.PGOConfig(**dataclasses.asdict(MV_CFG))
    factors = [tpg._sanitize(f) for f in tpg._linearize(tg, tcfg)]
    plans = tpg.loop_plans(tg)
    _, D, D_loop = tpg._gradient_and_diag(factors, MV_N, plans)
    damp = tpg._damping(D, D_loop, tcfg.lm_damping)
    ks = torch.arange(MV_N)
    free = (ks > 0) & (ks < tg.n_nodes)
    v = torch.from_numpy(np.random.default_rng(seed).normal(size=(MV_N, 6)).astype(np.float32))
    return factors, plans, damp, free, v


@pytest.mark.parametrize("case", list(CASES))
def test_hess_matvec_matches_reference(case):
    jg, tg = _graph(*CASES[case])
    factors, plans, damp, free, v = _port_inputs(tg)
    got = tpg._hess_matvec(factors, v, damp, plans, free).numpy()
    want = np.asarray(_reference_matvec(jg, jnp.asarray(v.numpy()), jnp.asarray(damp.numpy()),
                                        jnp.asarray(free.numpy())))
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= MV_REL_TOL * scale
    assert np.all(got[~free.numpy()] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_hess_matvec_plain_is_the_former_composition(case):
    _, tg = _graph(*CASES[case])
    factors, plans, damp, free, v = _port_inputs(tg, seed=5)
    before = hess_matvec.hess_matvec.launches
    got = tpg._hess_matvec(factors, v, damp, plans, free)
    assert hess_matvec.hess_matvec.launches == before  # the CPU runs the plain version
    odom, loops, gps = factors
    former = lambda mask: chip_smoke.former_matvec(torch, odom, gps, loops, plans, v, damp, mask)
    assert torch.equal(got, former(free))
    # no mask: every node free
    assert torch.equal(tpg._hess_matvec(factors, v, damp, plans), former(torch.ones_like(free)))


def test_hess_matvec_row_order_decides_the_bits():
    """A node reached by several loop rows adds them in ascending row
    order: permuting the rows (and their plan) changes the float sum only
    through that order, so the plain version must equal a row-by-row walk."""
    _, tg = _graph(*CASES["shared_loops_gps_padding"])
    factors, plans, damp, free, v = _port_inputs(tg, seed=6)
    odom, loops, gps_f = factors
    base = tpg._hess_matvec([odom, loops._replace(W=torch.zeros_like(loops.W)), gps_f], v, damp,
                            plans, free)
    fm = free[:, None]
    vm = torch.where(fm, v, 0.0)
    WAvl = loops.W * (hess_matvec.mat_vec(loops.Ji, vm[loops.i])
                      + hess_matvec.mat_vec(loops.Jj, vm[loops.j]))
    rows = (hess_matvec.mat_t_vec(loops.Ji, WAvl), hess_matvec.mat_t_vec(loops.Jj, WAvl))
    want = base.clone()
    for ends, r in ((loops.i, rows[0]), (loops.j, rows[1])):
        for m in range(int(tg.n_loops)):
            if free[ends[m]]:
                want[ends[m]] = want[ends[m]] + r[m]
    assert torch.equal(tpg._hess_matvec(factors, v, damp, plans, free), want)


# ---------------------------------------------------------------- Kabsch step

def _cloud(rng, S, scale=10.0, planar=False):
    src = rng.normal(size=(S, 3)) * scale
    if planar:
        src[:, 2] *= 1e-3
    return src.astype(np.float32)


def _moved(rng, src, B, angle=0.05, noise=0.01):
    out = []
    for b in range(B):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        R = np.asarray(jse3.quat_to_mat(jse3.exp_so3(jnp.asarray(axis * angle * (b + 1),
                                                                 jnp.float32))))
        out.append(src @ R.T + rng.normal(size=3) + rng.normal(size=src.shape) * noise)
    return np.stack(out).astype(np.float32)


def test_kabsch_step_matches_one_reference_icp_step():
    """One iteration of the reference's brute-force ICP from the identity
    (no trimming) against the step on the same correspondences, at the
    coarse stage's 2048 points."""
    rng = np.random.default_rng(7)
    S = 2048
    src = _cloud(rng, S)
    target = _moved(rng, src, 1)[0]
    smask = rng.uniform(size=S) > 0.1
    tmask = np.ones(S, bool)
    ident = JPose(jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    res = jicp.icp_point2point(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(target),
                               jnp.asarray(tmask), ident, max_corr_dist=150.0, iterations=1,
                               trim_fraction=1.0, transformation_eps=0.0)
    d2, idx = jvoxel.nn1(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(target),
                         jnp.asarray(tmask))
    w = (smask & (np.asarray(d2) < 150.0 ** 2)).astype(np.float32)
    got = kabsch.kabsch_step(torch.from_numpy(src), torch.from_numpy(w[None]),
                             torch.from_numpy(target[np.asarray(idx)][None]), False)
    assert _quat_err(got.quat.numpy(), res.transform.quat) <= STEP_Q_TOL
    assert np.abs(got.trans.numpy()[0] - np.asarray(res.transform.trans)).max() <= STEP_T_TOL


F64_CASES = {  # (seed, batch rows, points, mask_q)
    "coarse_2x2048": (11, 2, 2048, False), "fine_8192_masked": (12, 1, 8192, True),
    "ragged_1000": (13, 2, 1000, True), "near_planar": (14, 1, 4096, True),
    "sparse_weights": (15, 2, 2048, False),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_kabsch_step_matches_float64(case):
    seed, B, S, mask_q = F64_CASES[case]
    rng = np.random.default_rng(seed)
    src = _cloud(rng, S, planar=case == "near_planar")
    tgt = _moved(rng, src, B)
    keep = 0.02 if case == "sparse_weights" else 0.8
    w = (rng.uniform(size=(B, S)) < keep).astype(np.float32)
    got = kabsch.kabsch_step(torch.from_numpy(src), torch.from_numpy(w), torch.from_numpy(tgt),
                             mask_q)
    for b in range(B):
        R, t = _f64_kabsch(src, w[b], tgt[b], mask_q)
        want_q = np.asarray(jse3.mat_to_quat(jnp.asarray(R, jnp.float32)))
        assert _quat_err(got.quat.numpy()[b], want_q) <= F64_Q_TOL
        assert np.abs(got.trans.numpy()[b] - t).max() <= F64_T_TOL


@pytest.mark.parametrize("mask_q", [False, True])
def test_kabsch_step_rotation_is_kabsch_plain_on_its_h(mask_q):
    """The step's pose is mat_to_quat(kabsch_plain(H)) and mu_t - R mu_s on
    the H and centroids it sums, bit for bit; each batch row alone gives
    the same bits as in the batch."""
    rng = np.random.default_rng(8)
    S = 3000
    src = torch.from_numpy(_cloud(rng, S))
    tgt = torch.from_numpy(_moved(rng, src.numpy(), 2))
    w = torch.from_numpy((rng.uniform(size=(2, S)) < 0.7).astype(np.float32))
    got = kabsch.kabsch_step(src, w, tgt, mask_q)
    mu_s, mu_t, H = kabsch.kabsch_step_parts(src[None], w, tgt, mask_q)
    R = kabsch.kabsch_plain(H)
    assert torch.equal(got.quat, tse3.mat_to_quat(R, f32.sqrt))
    Rmu = (R[:, :, 0] * mu_s[:, :1] + R[:, :, 1] * mu_s[:, 1:2]) + R[:, :, 2] * mu_s[:, 2:]
    assert torch.equal(got.trans, mu_t - Rmu)
    for b in range(2):
        one = kabsch.kabsch_step(src, w[b:b + 1], tgt[b:b + 1], mask_q)
        assert torch.equal(one.quat[0], got.quat[b]) and torch.equal(one.trans[0], got.trans[b])


def test_kabsch_plain_square_roots_round_correctly():
    """The plain versions' square root (f32.sqrt) is the correctly rounded
    one (numpy's float32 sqrt), as the kernels' __fsqrt_rn, where the CPU's
    torch.sqrt misrounds some inputs by an ulp."""
    rng = np.random.default_rng(16)
    x = np.concatenate([rng.uniform(0.5, 4.0, 50000), 10.0 ** rng.uniform(-30, 30, 50000),
                        [0.0, 1.0, 1.0216779708862305]]).astype(np.float32)
    got = f32.sqrt(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    assert got[-1] == np.float32(1.0107809)


def test_kabsch_step_zero_weights_and_mask_q():
    """All-zero weights give the identity and a zero translation (H = 0,
    wsum clamped to 1); with mask_q the targets of zero-weight rows do not
    reach the result, which equals the unmasked step's."""
    rng = np.random.default_rng(9)
    S = 700
    src = torch.from_numpy(_cloud(rng, S))
    tgt = torch.from_numpy(_moved(rng, src.numpy(), 2))
    zero = kabsch.kabsch_step(src, torch.zeros(2, S), tgt, True)
    assert torch.equal(zero.quat, torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2))
    assert torch.equal(zero.trans, torch.zeros(2, 3))
    w = torch.from_numpy((rng.uniform(size=(2, S)) < 0.5).astype(np.float32))
    masked = kabsch.kabsch_step(src, w, tgt, True)
    far = torch.where(w[..., None] > 0, tgt, tgt + 1e3)
    moved = kabsch.kabsch_step(src, w, far, True)
    plain = kabsch.kabsch_step(src, w, tgt, False)
    assert torch.equal(masked.quat, moved.quat) and torch.equal(masked.trans, moved.trans)
    assert torch.equal(masked.quat, plain.quat) and torch.equal(masked.trans, plain.trans)


def test_kabsch_step_vmap_folds_the_batch():
    """Under torch.func.vmap the step equals a call a problem, bit for bit,
    with the source shared or per problem."""
    rng = np.random.default_rng(10)
    S, V = 600, 3
    src = torch.from_numpy(np.stack([_cloud(rng, S) for _ in range(V)]))
    tgt = torch.from_numpy(np.stack([_moved(rng, s.numpy(), 2) for s in src]))
    w = torch.from_numpy((rng.uniform(size=(V, 2, S)) < 0.6).astype(np.float32))
    per = torch.func.vmap(lambda s, ww, t: kabsch.kabsch_step(s, ww, t, True))(src, w, tgt)
    shared = torch.func.vmap(lambda ww, t: kabsch.kabsch_step(src[0], ww, t, False))(w, tgt)
    for i in range(V):
        a = kabsch.kabsch_step(src[i], w[i], tgt[i], True)
        b = kabsch.kabsch_step(src[0], w[i], tgt[i], False)
        assert torch.equal(per.quat[i], a.quat) and torch.equal(per.trans[i], a.trans)
        assert torch.equal(shared.quat[i], b.quat) and torch.equal(shared.trans[i], b.trans)
