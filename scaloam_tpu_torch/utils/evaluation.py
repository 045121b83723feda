"""Trajectory evaluation: ATE RMSE, the benchmark metric (BASELINE.md).

The reference saves KITTI-format poses for evo/kitti-devkit evaluation
(src/laserPosegraphOptimization.cpp:236-259). This module computes the same
ATE RMSE directly: optional SE(3) (or Sim3-less, scale=1) Umeyama alignment
followed by RMS of translational residuals — evo's `ape -a` equivalent.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares SE(3) aligning src[N,3] onto dst[N,3] (no scale)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S, D = src - mu_s, dst - mu_d
    H = S.T @ D / len(src)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    C = np.diag([1.0, 1.0, d])
    R = Vt.T @ C @ U.T
    t = mu_d - R @ mu_s
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, align: bool = True
) -> float:
    """ATE RMSE between [N,4,4] (or [N,3] position) trajectories."""
    p_est = est[:, :3, 3] if est.ndim == 3 else est
    p_gt = gt[:, :3, 3] if gt.ndim == 3 else gt
    assert p_est.shape == p_gt.shape
    if align:
        T = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=-1))))
