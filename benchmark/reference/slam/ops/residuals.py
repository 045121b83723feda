"""Lidar residuals with analytic Jacobians (counterpart of
scaloam_tpu/ops/residuals.py).

Pose (q, t) maps p to p' = R(q) p + t; the perturbation (dtheta, dt) acts
as q <- q * Exp(dtheta), t <- t + dt. The hot-path builders are SoA:
factor data is [3, n] (one column per correspondence) and each returns
r [R, n], J [R, 6, n] and valid [n]. With per-point de-skew fractions s
(the reference's DISTORTION mode) the pose is slerp-interpolated per point.
The AoS builders ([n, 3] data, r [n, R], J [n, R, 6]) keep the reference's
per-point 3x3 form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.slam.ops import se3
from reference.slam.types import Pose

_EPS = 1e-9


class FactorSet(NamedTuple):
    r: torch.Tensor  # [n, R]
    J: torch.Tensor  # [n, R, 6]
    valid: torch.Tensor  # [n] bool


class FactorSetT(NamedTuple):
    r: torch.Tensor  # [R, n]
    J: torch.Tensor  # [R, 6, n]
    valid: torch.Tensor  # [n] bool


def _slerp_quats(pose: Pose, s: torch.Tensor) -> torch.Tensor:
    """slerp(I, q, s) for each fraction s [n] -> [n, 4]."""
    q = pose.quat.expand(s.shape + (4,))
    ident = torch.zeros_like(q)
    ident[..., 0].fill_(1.0)
    return se3.quat_slerp(ident, q, s[..., None])


def transform_points(pose: Pose, pts: torch.Tensor, s: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """TransformToStart (src/laserOdometry.cpp:111-129): de-skew by the
    slerp-interpolated pose; s=None (DISTORTION off) applies the full pose."""
    if s is None:
        return se3.apply(pose, pts)
    return se3.quat_rotate(_slerp_quats(pose, s), pts) + s[..., None] * pose.trans


def _cross_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of [3, n] column-vector bundles."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _col_norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of each column of [3, n]."""
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _slerp_cols(pose: Pose, pT: torch.Tensor, s: torch.Tensor):
    """Per-point slerp-s pose pieces of the de-skew factors
    (src/lidarFactor.hpp:26-34): (q_s [n, 4], w = R_s p [3, n], the columns
    of R_s as 3 x [3, n])."""
    n = pT.shape[1]
    q_s = _slerp_quats(pose, s)
    w = se3.quat_rotate(q_s, pT.T).T
    eye = torch.eye(3, dtype=pT.dtype, device=pT.device)
    R_cols = [se3.quat_rotate(q_s, eye[k].expand(n, 3)).T for k in range(3)]
    return q_s, w, R_cols


class EdgePrepT(NamedTuple):
    """Pose-independent half of the edge factor, prepared once per
    association pass."""

    pT: torch.Tensor  # [3, n]
    aT: torch.Tensor
    bT: torch.Tensor
    d: torch.Tensor  # aT - bT
    dn: torch.Tensor  # [1, n]
    J_t: torch.Tensor  # [3, 3, n] translation block
    valid: torch.Tensor


def edge_prep_T(pT, aT, bT, valid) -> EdgePrepT:
    d = aT - bT
    dn = torch.clamp(_col_norm(d), min=_EPS)[None, :]
    e = torch.eye(3, dtype=pT.dtype, device=pT.device)
    J_t = torch.stack(
        [_cross_rows(e[:, k : k + 1].expand(d.shape), d) / dn for k in range(3)],
        dim=1,
    )
    return EdgePrepT(pT=pT, aT=aT, bT=bT, d=d, dn=dn, J_t=J_t, valid=valid)


def edge_factors_from_prep(pose: Pose, prep: EdgePrepT) -> FactorSetT:
    """Point-to-line r = (p'-a) x (p'-b) / |a-b| relinearized at `pose`."""
    R = se3.quat_to_mat(pose.quat)
    w = torch.matmul(R, prep.pT)  # R p
    pw = w + pose.trans[:, None]
    r = _cross_rows(pw - prep.aT, pw - prep.bT) / prep.dn
    J_rot = torch.stack(
        [
            _cross_rows(_cross_rows(R[:, k : k + 1].expand(w.shape), w), prep.d)
            / prep.dn
            for k in range(3)
        ],
        dim=1,
    )
    J = torch.cat([J_rot, prep.J_t], dim=1)  # [3, 6, n]
    return FactorSetT(r=r, J=J, valid=prep.valid)


def edge_factors_T(pose: Pose, pT, aT, bT, valid, s: Optional[torch.Tensor] = None
                   ) -> FactorSetT:
    """Point-to-line r = (p'-a) x (p'-b) / |a-b|. With de-skew fractions s:
    p' = R_s p + s t, R_s = slerp(I, q, s), and the Jacobian from
    slerp(I, q exp(delta), s) ~= R_s exp(s delta), as the reference's."""
    if s is None:
        return edge_factors_from_prep(pose, edge_prep_T(pT, aT, bT, valid))
    d = aT - bT
    dn = torch.clamp(_col_norm(d), min=_EPS)[None, :]
    e = torch.eye(3, dtype=pT.dtype, device=pT.device)
    _, w, R_cols = _slerp_cols(pose, pT, s)
    sc = s[None, :]
    pw = w + sc * pose.trans[:, None]
    r = _cross_rows(pw - aT, pw - bT) / dn
    J_rot = [sc * _cross_rows(_cross_rows(R_cols[k], w), d) / dn for k in range(3)]
    J_t = [sc * _cross_rows(e[:, k : k + 1].expand(d.shape), d) / dn for k in range(3)]
    return FactorSetT(r=r, J=torch.stack(J_rot + J_t, dim=1), valid=valid)


def plane3_prep_T(jT, lT, mT):
    """Unit normal and offset of the 3-point correspondence plane."""
    nrm = _cross_rows(jT - lT, jT - mT)
    nrm = nrm / torch.clamp(_col_norm(nrm), min=_EPS)[None, :]
    return nrm, -torch.sum(jT * nrm, dim=0)


def plane3_factors_T(pose: Pose, pT, jT, lT, mT, valid,
                     s: Optional[torch.Tensor] = None) -> FactorSetT:
    """Point-to-plane through 3 points, r = (p' - j) . normalize((j-l)x(j-m));
    s: optional de-skew fractions (see edge_factors_T)."""
    nrm, neg_d = plane3_prep_T(jT, lT, mT)
    return _plane_T(pose, pT, nrm, neg_d, valid, s=s)


def plane_norm_factors_T(pose: Pose, pT, unit_normT, neg_oa_dot, valid) -> FactorSetT:
    """Point-to-plane r = n . p' + d."""
    return _plane_T(pose, pT, unit_normT, neg_oa_dot, valid)


def _plane_T(pose: Pose, pT, nT, neg_d, valid, s: Optional[torch.Tensor] = None
             ) -> FactorSetT:
    if s is None:
        R = se3.quat_to_mat(pose.quat)
        pw = torch.matmul(R, pT) + pose.trans[:, None]
        u = torch.matmul(R.T, nT)  # R^T n
        J_rot = _cross_rows(pT, u)  # (p x R^T n)^T
        J_n = nT
    else:
        q_s, w, _ = _slerp_cols(pose, pT, s)
        sc = s[None, :]
        pw = w + sc * pose.trans[:, None]
        u = se3.quat_rotate(se3.quat_conj(q_s), nT.T).T  # R_s^T n per point
        J_rot = sc * _cross_rows(pT, u)
        J_n = sc * nT
    r = (torch.sum(nT * pw, dim=0) + neg_d)[None, :]
    J = torch.cat([J_rot, J_n], dim=0)[None, :, :]  # [1, 6, n]
    return FactorSetT(r=r, J=J, valid=valid)
