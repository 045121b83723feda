"""Lidar residuals with analytic Jacobians, SoA layout
(counterpart of the s=None factor functions in scaloam_tpu/ops/residuals.py).

Pose (q, t) maps p to p' = R(q) p + t; the perturbation (dtheta, dt) acts
as q <- q * Exp(dtheta), t <- t + dt. Factor data is [3, n] (one column
per correspondence); each factor function returns r [R, n], J [R, 6, n]
and valid [n]. The de-skew (slerp) factor functions are not ported: the
port's odometry refuses `distortion=True`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scaloam_tpu_torch.ops import se3
from scaloam_tpu_torch.types import Pose

_EPS = 1e-9


class FactorSetT(NamedTuple):
    r: torch.Tensor  # [R, n]
    J: torch.Tensor  # [R, 6, n]
    valid: torch.Tensor  # [n] bool


def transform_points(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """TransformToStart with DISTORTION off: the full pose."""
    return se3.apply(pose, pts)


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


def plane3_prep_T(jT, lT, mT):
    """Unit normal and offset of the 3-point correspondence plane."""
    nrm = _cross_rows(jT - lT, jT - mT)
    nrm = nrm / torch.clamp(_col_norm(nrm), min=_EPS)[None, :]
    return nrm, -torch.sum(jT * nrm, dim=0)


def plane_norm_factors_T(pose: Pose, pT, unit_normT, neg_oa_dot, valid) -> FactorSetT:
    """Point-to-plane r = n . p' + d."""
    return _plane_T(pose, pT, unit_normT, neg_oa_dot, valid)


def _plane_T(pose: Pose, pT, nT, neg_d, valid) -> FactorSetT:
    R = se3.quat_to_mat(pose.quat)
    pw = torch.matmul(R, pT) + pose.trans[:, None]
    u = torch.matmul(R.T, nT)  # R^T n
    r = (torch.sum(nT * pw, dim=0) + neg_d)[None, :]
    J_rot = _cross_rows(pT, u)  # (p x R^T n)^T
    J = torch.cat([J_rot, nT], dim=0)[None, :, :]  # [1, 6, n]
    return FactorSetT(r=r, J=J, valid=valid)
