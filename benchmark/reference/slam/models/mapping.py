"""Scan-to-map refinement (counterpart of scaloam_tpu/models/mapping.py).

Per frame: prior = correction o odom_pose; inputs voxel-downsampled
(0.4 m corners, 0.8 m surfs); with a dense enough map, 2 outer passes of
5-NN line / plane fits against the torus grid map, each followed by 4 GN
iterations of kernel K2's prepared-factor entry
(ops/kernels/gn_odometry.py:gn_solve_prepared); then the inputs are
inserted at the refined pose. With a sparse map the prior is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.slam.config import SlamConfig
from reference.slam.ops import fit, gridmap, se3, voxel
from reference.slam.ops.kernels import f32ops, gn_odometry
from reference.slam.types import FeatureCloud, Pose


class MappingState(NamedTuple):
    corner_grid: gridmap.GridMap
    surf_grid: gridmap.GridMap
    correction: Pose  # wmap_T_wodom (transformIncremental)
    pose: Pose  # last refined map pose (aft_mapped)
    frame_idx: torch.Tensor


class MappingOutput(NamedTuple):
    pose: Pose  # refined world pose ("/aft_mapped_to_init")
    correction: Pose
    n_corner_corr: torch.Tensor
    n_surf_corr: torch.Tensor
    map_corner_count: torch.Tensor
    map_surf_count: torch.Tensor


_CAND_K = 8  # cached candidate superset per query (re-ranked each pass)


def _candidates(pose: Pose, pts, pmask, grid: gridmap.GridMap, mcfg):
    """One grid k-NN gather at `pose`: a top-8 candidate superset [Q, 8, 3]
    that each outer pass re-ranks at its updated pose."""
    pw = se3.apply(pose, pts)
    _, nb = gridmap.knn_grid(
        grid, pw, pmask, mcfg.grid_xy, mcfg.grid_xy, mcfg.grid_z,
        mcfg.cell_size, reach=1.0, k=max(_CAND_K, mcfg.knn),
    )
    return nb


def _rerank(pose: Pose, pts, nb8, k: int):
    """Exact k-NN among the cached candidates at `pose` (far-sentinel slots
    rank last). Returns (d [Q, k] ascending, nb [Q, k, 3])."""
    pw = se3.apply(pose, pts)
    d8 = f32ops.sum3_sq(nb8 - pw[:, None, :])  # [Q, 8], rounded as the reference ranks
    return voxel.argmin_topk(d8, k, nb8)


def _corner_correspond(pose: Pose, pts, pmask, nb8, mcfg):
    """5-NN -> covariance eigendecomposition -> line endpoints at
    mean +- 0.1 * dir. Returns (a, b, valid)."""
    d, nb = _rerank(pose, pts, nb8, mcfg.knn)
    ok_nn = pmask & (d[:, -1] < mcfg.corner_nn_max_dist)
    mean, cov = fit.neighborhood_cov(nb)
    vals, vdir = fit.eigh3x3(cov)
    is_edge = vals[:, 2] > mcfg.edge_eig_ratio * vals[:, 1]
    return mean + 0.1 * vdir, mean - 0.1 * vdir, ok_nn & is_edge


def _surf_correspond(pose: Pose, pts, pmask, nb8, mcfg):
    """5-NN -> plane fit -> every neighbor within plane_fit_tol.
    Returns (unit_norm, neg_d, valid)."""
    d, nb = _rerank(pose, pts, nb8, mcfg.knn)
    ok_nn = pmask & (d[:, -1] < mcfg.surf_nn_max_dist_sq)
    unit_n, neg_d, ok_fit = fit.fit_plane(nb)
    resid = torch.abs(torch.einsum("ni,nki->nk", unit_n, nb) + neg_d[:, None])
    planar = torch.all(resid <= mcfg.plane_fit_tol, dim=-1)
    return unit_n, neg_d, ok_nn & ok_fit & planar


def mapping_step(state: MappingState, odom_pose: Pose, corner_cloud: FeatureCloud,
                 surf_cloud: FeatureCloud, cfg: SlamConfig):
    """Returns (new_state, MappingOutput)."""
    m = cfg.mapping
    prior = se3.compose(state.correction, odom_pose)

    cin_xyz, cin_mask, _ = voxel.voxel_downsample_packed(
        corner_cloud.xyz, corner_cloud.mask, m.line_resolution,
        m.max_corner_input, xy_bits=10, z_bits=9,
    )
    sin_xyz, sin_mask, _ = voxel.voxel_downsample_packed(
        surf_cloud.xyz, surf_cloud.mask, m.plane_resolution,
        m.max_surf_input, xy_bits=10, z_bits=9,
    )
    dense_enough = (state.corner_grid.total > m.min_corner_map) & (
        state.surf_grid.total > m.min_surf_map
    )

    pose = prior
    n_c = n_s = torch.zeros((), dtype=torch.int32, device=cin_xyz.device)
    cmask = cin_mask & dense_enough
    smask = sin_mask & dense_enough
    nb8_c = _candidates(prior, cin_xyz, cmask, state.corner_grid, m)
    nb8_s = _candidates(prior, sin_xyz, smask, state.surf_grid, m)
    for _ in range(m.outer_iterations):
        a, b, cv = _corner_correspond(pose, cin_xyz, cmask, nb8_c, m)
        un, nd, sv = _surf_correspond(pose, sin_xyz, smask, nb8_s, m)
        n_c = torch.sum(cv).to(torch.int32)
        n_s = torch.sum(sv).to(torch.int32)
        # Kernel K2's prepared-factor entry (its plain version on the CPU).
        q, t = gn_odometry.gn_solve_prepared(
            pose.quat, pose.trans, cin_xyz, a, b, cv, sin_xyz, un, nd, sv,
            gn_iterations=m.gn_iterations, huber_delta=m.huber_delta,
        )
        pose = Pose(q, t)

    # Degenerate guard: with a sparse map keep the prior.
    pose = Pose(
        torch.where(dense_enough, pose.quat, prior.quat),
        torch.where(dense_enough, pose.trans, prior.trans),
    )
    correction = se3.compose(pose, se3.inverse(odom_pose))

    corner_grid = gridmap.insert(
        state.corner_grid, se3.apply(pose, cin_xyz), cin_mask,
        m.grid_xy, m.grid_xy, m.grid_z, m.cell_size, m.line_resolution,
    )
    surf_grid = gridmap.insert(
        state.surf_grid, se3.apply(pose, sin_xyz), sin_mask,
        m.grid_xy, m.grid_xy, m.grid_z, m.cell_size, m.plane_resolution,
    )
    new_state = MappingState(
        corner_grid=corner_grid, surf_grid=surf_grid, correction=correction,
        pose=pose, frame_idx=state.frame_idx + 1,
    )
    return new_state, MappingOutput(
        pose=pose, correction=correction, n_corner_corr=n_c, n_surf_corr=n_s,
        map_corner_count=corner_grid.total, map_surf_count=surf_grid.total,
    )


