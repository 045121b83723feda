"""Batched closed-form 3x3 eigendecomposition and plane fitting
(counterpart of scaloam_tpu/ops/fit.py).

The trigonometric closed form is kept (not torch.linalg.eigh) so the
eigenvalue order and the returned eigenvector match the reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) of symmetric [..., 3, 3] plus the eigenvector
    of the LARGEST eigenvalue. Returns (eigvals [..., 3], v_max [..., 3])."""
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    det_b = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min
    vals = torch.stack([e_min, e_mid, e_max], dim=-1)

    # Eigenvector of e_max: column of (A - e_min I)(A - e_mid I) with max norm.
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = torch.matmul(
        A - e_min[..., None, None] * eye, A - e_mid[..., None, None] * eye
    )
    norms = torch.sum(M * M, dim=-2)  # column squared norms [..., 3]
    col = torch.argmax(norms, dim=-1)  # first of equal maxima
    idx = col[..., None, None].expand(M.shape[:-1] + (1,))
    v = torch.gather(M, -1, idx)[..., 0]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = v / torch.clamp(vn, min=1e-20)
    return vals, v


def neighborhood_cov(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean + 1/K covariance over the K-neighbor axis: pts [..., K, 3] ->
    (mean [..., 3], cov [..., 3, 3])."""
    mean = torch.mean(pts, dim=-2)
    d = pts - mean[..., None, :]
    cov = torch.einsum("...ki,...kj->...ij", d, d) / pts.shape[-2]
    return mean, cov


def fit_plane(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane through pts [..., K, 3] as (unit_norm, neg_d, ok) with
    n.p + neg_d ~= 0 and n.centroid < 0: the smallest eigenvector of the
    centered covariance (centered TLS, see the reference's fit_plane)."""
    mean, cov = neighborhood_cov(pts)
    tr = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    vals_f, v = eigh3x3(tr[..., None, None] * eye - cov)
    lam_min = tr - vals_f[..., 2]
    lam_mid = tr - vals_f[..., 1]
    s = torch.where(torch.sum(v * mean, dim=-1) > 0, -1.0, 1.0)
    n = v * s[..., None]
    neg_d = -torch.sum(n * mean, dim=-1)
    ok = (lam_mid > torch.clamp(4.0 * lam_min, min=1e-12)) & torch.all(
        torch.isfinite(n), dim=-1
    )
    n = torch.where(ok[..., None], n, 0.0)
    neg_d = torch.where(ok, neg_d, 0.0)
    return n, neg_d, ok
