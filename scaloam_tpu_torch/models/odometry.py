"""Scan-to-scan odometry (counterpart of scaloam_tpu/models/odometry.py).

Per frame: brute-force 2-NN sweeps give two cached candidates per
correspondence class at the warm-start pose, then kernel K2 (see
ops/kernels/gn_odometry.py) re-ranks them and runs the 2 x 4 Gauss-Newton
iterations; the world pose integrates the frame-to-frame estimate and the
current less-sharp / less-flat clouds become the next frame's targets.

The reference's `lax.cond` on `initialized` is a branch on a host bool kept
in the state. The de-skew path (`distortion=True`, off in every preset) is
not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scaloam_tpu_torch import device as _device
from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.ops import correspond, gn, residuals, se3, voxel
from scaloam_tpu_torch.ops.kernels import gn_odometry
from scaloam_tpu_torch.types import FeatureCloud, Pose, ScanFeatures


class OdometryState(NamedTuple):
    last_corner: FeatureCloud  # previous less-sharp
    last_surf: FeatureCloud  # previous less-flat
    rel: Pose  # frame-to-frame estimate (warm start)
    world: Pose  # accumulated odometry ("/laser_odom_to_init")
    initialized: bool  # host-side, so the first-frame branch needs no device read
    frame_idx: torch.Tensor  # int32
    feat_overflow: torch.Tensor  # int32 running max of ScanFeatures.overflow
    degenerate_count: torch.Tensor  # int32 frames below min_correspondences


class OdometryOutput(NamedTuple):
    world: Pose
    rel: Pose
    n_corner_corr: torch.Tensor
    n_surf_corr: torch.Tensor
    degenerate: torch.Tensor  # bool: fewer than min_correspondences total


def init_state(cfg: SlamConfig, device=None) -> OdometryState:
    dev = _device.resolve(device)
    feat = cfg.features
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OdometryState(
        last_corner=FeatureCloud.empty(feat.max_less_sharp, dev),
        last_surf=FeatureCloud.empty(feat.max_less_flat, dev),
        rel=Pose.identity(dev),
        world=Pose.identity(dev),
        initialized=False,
        frame_idx=zero,
        feat_overflow=zero,
        degenerate_count=zero,
    )


def _sweep_candidates(rel: Pose, feats: ScanFeatures, state: OdometryState,
                      cfg: SlamConfig):
    """Full-cloud correspondence sweeps at the warm-start pose, two
    candidates deep per class (corners: any / other-ring; surfs: any /
    same-ring / other-ring), each [Q, 2, 3]. The 1-NN's ring (the
    same/other boundary) is frozen at the sweep pose."""
    ocfg = cfg.odometry

    def sweep(q_cloud, t_cloud, want_same):
        q = residuals.transform_points(rel, q_cloud.xyz)
        iota = torch.arange(t_cloud.xyz.shape[0], dtype=torch.float32, device=q.device)
        payload = torch.cat([t_cloud.xyz, t_cloud.ring[:, None], iota[:, None]], dim=1)
        _, P = voxel.knn2_payload(q, q_cloud.mask, t_cloud.xyz, t_cloud.mask, payload, tile=8192)
        any_pts = P[:, :, :3].contiguous()
        ring_j = P[:, 0, 3]
        excl = P[:, 0, 4].to(torch.int64)  # exact: index < 2^24
        _, p_same, _, p_other = correspond.ring_constrained_nn2_pts(
            q, q_cloud.mask, ring_j, excl, t_cloud.xyz, t_cloud.mask,
            t_cloud.ring, ocfg.nearby_scan, tile=4096, want_same=want_same,
        )
        return (any_pts, p_same, p_other) if want_same else (any_pts, p_other)

    corner_cand = sweep(feats.sharp, state.last_corner, want_same=False)
    surf_cand = sweep(feats.flat, state.last_surf, want_same=True)
    return corner_cand, surf_cand


def _pick1(q: torch.Tensor, cand: torch.Tensor):
    """Nearer of the two cached candidates at the current pose.
    q [Q, 3], cand [Q, 2, 3] -> (d [Q], pt [Q, 3])."""
    diff = cand - q[:, None, :]
    d = se3.sq_norm(diff)  # [Q, 2]
    take2 = d[:, 1] < d[:, 0]
    pt = torch.where(take2[:, None], cand[:, 1], cand[:, 0])
    return torch.minimum(d[:, 0], d[:, 1]), pt


def _associate(rel: Pose, c_xyz, c_mask, s_xyz, s_mask, corner_cand,
               surf_cand, thr: float):
    """One data-association pass: re-rank the cached candidates at `rel`.
    Returns corner_data (p, a, b, valid) and surf_data (p, j, l, m, valid)."""
    q_pts = residuals.transform_points(rel, c_xyz)
    dj, a = _pick1(q_pts, corner_cand[0])
    do, b = _pick1(q_pts, corner_cand[1])
    corner_valid = c_mask & (dj < thr) & (do < thr)

    qs_pts = residuals.transform_points(rel, s_xyz)
    sdj, j = _pick1(qs_pts, surf_cand[0])
    ds, l = _pick1(qs_pts, surf_cand[1])
    do2, m = _pick1(qs_pts, surf_cand[2])
    surf_valid = s_mask & (sdj < thr) & (ds < thr) & (do2 < thr)
    return (c_xyz, a, b, corner_valid), (s_xyz, j, l, m, surf_valid)


def _solve(rel: Pose, corner_data, surf_data, gn_iterations: int,
           huber_delta: float, damping: float = 1e-6) -> Pose:
    """GN on the frozen correspondences; the pose-independent factor halves
    (edge lines, plane normals) are prepared once."""
    p_c, a, b, v_c = corner_data
    p_s, j, l, m, v_s = surf_data
    prep_e = residuals.edge_prep_T(p_c.T, a.T, b.T, v_c)
    nrmT, neg_d = residuals.plane3_prep_T(j.T, l.T, m.T)
    psT = p_s.T

    def build(pose):
        return [
            residuals.edge_factors_from_prep(pose, prep_e),
            residuals.plane_norm_factors_T(pose, psT, nrmT, neg_d, v_s),
        ]

    return gn.gauss_newton(rel, build, gn_iterations, huber_delta, damping)


def odometry_step(state: OdometryState, feats: ScanFeatures, cfg: SlamConfig):
    """Process one feature frame; returns (new_state, OdometryOutput)."""
    ocfg = cfg.odometry
    if ocfg.distortion:
        raise NotImplementedError("the de-skew (distortion=True) path is not ported")
    dev = feats.sharp.xyz.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if state.initialized:
        corner_cand, surf_cand = _sweep_candidates(state.rel, feats, state, cfg)
        q, t, n_c, n_s = gn_odometry.associate_and_solve(
            feats.sharp.xyz, corner_cand[0], corner_cand[1], feats.sharp.mask,
            feats.flat.xyz, surf_cand[0], surf_cand[1], surf_cand[2],
            feats.flat.mask, state.rel.quat, state.rel.trans,
            outer_iterations=ocfg.outer_iterations,
            gn_iterations=ocfg.gn_iterations,
            thr=ocfg.distance_sq_threshold,
            huber_delta=ocfg.huber_delta,
        )
        rel = Pose(q, t)
        degenerate = (n_c + n_s) < ocfg.min_correspondences
    else:
        rel = Pose.identity(dev)
        n_c = n_s = zero
        degenerate = torch.zeros((), dtype=torch.bool, device=dev)

    world = se3.compose(state.world, rel)
    new_state = OdometryState(
        last_corner=feats.less_sharp,
        last_surf=feats.less_flat,
        rel=rel,
        world=world,
        initialized=True,
        frame_idx=state.frame_idx + 1,
        feat_overflow=torch.maximum(state.feat_overflow, feats.overflow),
        degenerate_count=state.degenerate_count + degenerate.to(torch.int32),
    )
    return new_state, OdometryOutput(
        world=world, rel=rel, n_corner_corr=n_c, n_surf_corr=n_s, degenerate=degenerate
    )
