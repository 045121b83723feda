"""Gauss-Newton pose solves: the program's kernel K2 (csrc/gn_odometry.cu,
two entry points) as its plain versions.

- `associate_and_solve` (entry A, the TPU kernel
  scaloam_tpu/ops/pallas/gn_odometry.py:associate_and_solve): per outer
  pass the odometry model's _associate (candidate re-rank) and _solve (GN).
- `gn_solve_prepared` (entry B, mapping's GN loop,
  scaloam_tpu/models/mapping.py:187): gn.gauss_newton over
  residuals.edge_factors_from_prep and plane_norm_factors_T.
"""


import torch

from reference.slam.ops import gn, residuals
from reference.slam.types import Pose


def associate_and_solve(c_xyz, c_any, c_other, c_mask,
                        s_xyz, s_any, s_same, s_other, s_mask,
                        quat0, trans0, *, outer_iterations: int,
                        gn_iterations: int, thr: float,
                        huber_delta: float, damping: float = 1e-6):
    """What entry A fuses: outer_iterations passes of the odometry model's
    _associate (candidate re-rank) and _solve (GN)."""
    from reference.slam.models import odometry  # imports this module

    rel = Pose(quat0, trans0)
    n_c = n_s = torch.zeros((), dtype=torch.int32, device=c_xyz.device)
    for _ in range(outer_iterations):
        corner_data, surf_data = odometry._associate(
            rel, c_xyz, c_mask, s_xyz, s_mask, (c_any, c_other),
            (s_any, s_same, s_other), thr,
        )
        rel = odometry._solve(rel, corner_data, surf_data, gn_iterations,
                              huber_delta, damping)
        n_c = torch.sum(corner_data[3]).to(torch.int32)
        n_s = torch.sum(surf_data[4]).to(torch.int32)
    return rel.quat, rel.trans, n_c, n_s


def gn_solve_prepared(quat0, trans0, c_p, c_a, c_b, c_valid,
                      s_p, s_n, s_neg_d, s_valid, *, gn_iterations: int,
                      huber_delta: float, damping: float = 1e-6):
    """What entry B computes: gn.gauss_newton over the edge and
    plane-normal factors, built as the mapping model builds them."""
    prep_e = residuals.edge_prep_T(c_p.T, c_a.T, c_b.T, c_valid)
    s_pT, s_nT = s_p.T, s_n.T

    def build(pose):
        return [
            residuals.edge_factors_from_prep(pose, prep_e),
            residuals.plane_norm_factors_T(pose, s_pT, s_nT, s_neg_d, s_valid),
        ]

    pose = gn.gauss_newton(Pose(quat0, trans0), build, gn_iterations, huber_delta, damping)
    return pose.quat, pose.trans
