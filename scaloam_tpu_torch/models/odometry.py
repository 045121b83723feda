"""Scan-to-scan odometry (counterpart of scaloam_tpu/models/odometry.py).

Per frame: brute-force 2-NN sweeps give two cached candidates per
correspondence class at the warm-start pose, then kernel K2 (see
ops/kernels/gn_odometry.py) re-ranks them and runs the 2 x 4 Gauss-Newton
iterations; the world pose integrates the frame-to-frame estimate and the
current less-sharp / less-flat clouds become the next frame's targets.

The reference's `lax.cond` on `initialized` is a branch on a host bool kept
in the state; a device bool (a batch of sequences whose flags differ) runs
the solve and selects, as the reference's cond does under `jax.vmap`.
With `distortion=True` (the reference's DISTORTION mode, off in every
preset) each point is de-skewed by the slerp-interpolated pose at its
sweep fraction: K2 is gated off as the reference gates its kernel off,
the re-rank and the per-iteration slerp factors run as plain PyTorch, and
the republished clouds are moved to the sweep's end (TransformToEnd).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from scaloam_tpu_torch import device as _device
from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.ops import correspond, gn, residuals, se3, voxel
from scaloam_tpu_torch.ops.kernels import f32ops, gn_odometry
from scaloam_tpu_torch.types import FeatureCloud, Pose, ScanFeatures


class OdometryState(NamedTuple):
    last_corner: FeatureCloud  # previous less-sharp
    last_surf: FeatureCloud  # previous less-flat
    rel: Pose  # frame-to-frame estimate (warm start)
    world: Pose  # accumulated odometry ("/laser_odom_to_init")
    # A host bool, so the first-frame branch needs no device read; or a
    # device bool (one per sequence of a batch whose flags differ), as in
    # the reference, and then the solve runs and a select takes its result.
    initialized: Union[bool, torch.Tensor]
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
        s = q_cloud.rel_time if ocfg.distortion else None
        q = residuals.transform_points(rel, q_cloud.xyz, s=s)
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
    d = f32ops.sum3_sq(diff)  # [Q, 2], rounded as the reference ranks
    take2 = d[:, 1] < d[:, 0]
    pt = torch.where(take2[:, None], cand[:, 1], cand[:, 0])
    return torch.minimum(d[:, 0], d[:, 1]), pt


def _associate(rel: Pose, c_xyz, c_mask, s_xyz, s_mask, corner_cand,
               surf_cand, thr: float, c_time=None, s_time=None):
    """One data-association pass: re-rank the cached candidates at `rel`,
    each point de-skewed by its sweep fraction when c_time / s_time are
    given. Returns corner_data (p, a, b, valid) and surf_data
    (p, j, l, m, valid)."""
    q_pts = residuals.transform_points(rel, c_xyz, s=c_time)
    dj, a = _pick1(q_pts, corner_cand[0])
    do, b = _pick1(q_pts, corner_cand[1])
    corner_valid = c_mask & (dj < thr) & (do < thr)

    qs_pts = residuals.transform_points(rel, s_xyz, s=s_time)
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


def _solve_deskew(rel: Pose, corner_data, surf_data, c_time, s_time,
                  gn_iterations: int, huber_delta: float) -> Pose:
    """GN with the slerp factors, relinearized per iteration (the per-point
    rotation leaves nothing pose-independent to prepare)."""
    p_c, a, b, v_c = corner_data
    p_s, j, l, m, v_s = surf_data
    pcT, aT, bT = p_c.T, a.T, b.T
    psT, jT, lT, mT = p_s.T, j.T, l.T, m.T

    def build(pose):
        return [
            residuals.edge_factors_T(pose, pcT, aT, bT, v_c, s=c_time),
            residuals.plane3_factors_T(pose, psT, jT, lT, mT, v_s, s=s_time),
        ]

    return gn.gauss_newton(rel, build, gn_iterations, huber_delta)


def _deskew_solve(rel: Pose, feats: ScanFeatures, corner_cand, surf_cand, ocfg):
    """The outer association passes with de-skew, in plain PyTorch (the
    reference runs no kernel here). Returns (rel, n_corner, n_surf)."""
    sharp, flat = feats.sharp, feats.flat
    for _ in range(ocfg.outer_iterations):
        corner_data, surf_data = _associate(
            rel, sharp.xyz, sharp.mask, flat.xyz, flat.mask, corner_cand, surf_cand,
            ocfg.distance_sq_threshold, c_time=sharp.rel_time, s_time=flat.rel_time)
        rel = _solve_deskew(rel, corner_data, surf_data, sharp.rel_time, flat.rel_time,
                            ocfg.gn_iterations, ocfg.huber_delta)
    n_c = torch.sum(corner_data[3]).to(torch.int32)
    n_s = torch.sum(surf_data[4]).to(torch.int32)
    return rel, n_c, n_s


def _to_end(rel: Pose, fc: FeatureCloud) -> FeatureCloud:
    """TransformToEnd (src/laserOdometry.cpp:131-146): de-skew to the sweep
    start, then move into the frame of the sweep's end."""
    p_start = residuals.transform_points(rel, fc.xyz, s=fc.rel_time)
    return fc._replace(xyz=se3.apply(se3.inverse(rel), p_start))


def odometry_step(state: OdometryState, feats: ScanFeatures, cfg: SlamConfig):
    """Process one feature frame; returns (new_state, OdometryOutput)."""
    ocfg = cfg.odometry
    dev = feats.sharp.xyz.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    flag = state.initialized
    solve = flag if isinstance(flag, bool) else True  # a device flag: solve, then select
    if solve and ocfg.distortion:
        corner_cand, surf_cand = _sweep_candidates(state.rel, feats, state, cfg)
        rel, n_c, n_s = _deskew_solve(state.rel, feats, corner_cand, surf_cand, ocfg)
        degenerate = (n_c + n_s) < ocfg.min_correspondences
    elif solve:
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
    if not isinstance(flag, bool):
        # The reference's lax.cond on the flag as jax.vmap runs it: both
        # branches, the skip branch's identity selected where not initialized.
        ident = Pose.identity(dev)
        rel = Pose(torch.where(flag, rel.quat, ident.quat),
                   torch.where(flag, rel.trans, ident.trans))
        n_c, n_s = torch.where(flag, n_c, zero), torch.where(flag, n_s, zero)
        degenerate = flag & degenerate

    world = se3.compose(state.world, rel)
    less_sharp, less_flat = feats.less_sharp, feats.less_flat
    if ocfg.distortion:
        # The next frame matches against clouds moved to this sweep's end.
        less_sharp, less_flat = _to_end(rel, less_sharp), _to_end(rel, less_flat)
    new_state = OdometryState(
        last_corner=less_sharp,
        last_surf=less_flat,
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
