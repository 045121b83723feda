"""Point-to-point ICP for loop verification (counterpart of
scaloam_tpu/ops/icp.py).

Alignment runs in the loop keyframe's local frame: the source is the
current keyframe in its own frame and the target a submap expressed
relative to the loop keyframe, so the result C satisfies C ~= T_loop^-1
T_curr and the loop factor is Z = C^-1. Each iteration solves a weighted
Kabsch problem, the whole step (centroids, H, the rotation of its 3x3
SVD with the determinant sign fix, t and the quaternion) one CUDA kernel
on the card (ops/kernels/kabsch.py `kabsch_step`, its plain version on
the CPU), and the trimming quantile is written out, so nothing is read
back. The iteration count is fixed; once the pose update falls
below the transformation epsilon the pose freezes, through a flag that
stays on the device, which gives the result of an early exit without
reading the device in the loop. The three functions are compiled steps
(compiled.jit) with the reference's static arguments; the inner two run
inside verify_loop's program, as nested `jax.jit`s do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops import gridmap as gm
from scaloam_tpu_torch.ops import se3, voxel
from scaloam_tpu_torch.ops.kernels import kabsch
from scaloam_tpu_torch.types import Pose

_TRIM_BIG = 1e30  # keeps trimmed-out rows above any quantile


class ICPResult(NamedTuple):
    transform: Pose  # aligns source onto target
    fitness: torch.Tensor  # mean squared NN distance
    converged: torch.Tensor  # bool: enough correspondences at the end


def _run_iters(one_iter, init: Pose, iterations: int, transformation_eps: float) -> Pose:
    """`iterations` calls of one_iter on a batch of poses [B]; a pose whose
    update fell below eps (squared translation step and quaternion
    alignment defect) stays frozen for the remaining iterations."""
    pose = init
    if transformation_eps <= 0.0:
        for _ in range(iterations):
            pose = one_iter(pose)
        return pose
    done = torch.zeros(init.quat.shape[:-1], dtype=torch.bool, device=init.quat.device)
    for _ in range(iterations):
        new = one_iter(pose)
        dt2 = torch.sum((new.trans - pose.trans) ** 2, dim=-1)
        qdefect = 1.0 - torch.abs(torch.sum(new.quat * pose.quat, dim=-1))
        pose = Pose(torch.where(done[..., None], pose.quat, new.quat),
                    torch.where(done[..., None], pose.trans, new.trans))
        done = done | ((dt2 < transformation_eps) & (qdefect < transformation_eps))
    return pose


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Row quantiles of x [B, S] with linear interpolation between the two
    nearest order statistics, weighted as jnp.quantile weighs them -> [B, 1]."""
    v, _ = torch.sort(x, dim=1)
    pos = q * (x.shape[1] - 1)
    lo = int(pos)
    hi = min(lo + 1, x.shape[1] - 1)
    w = pos - lo
    return v[:, lo:lo + 1] * (1.0 - w) + v[:, hi:hi + 1] * w


def _batched(init: Pose):
    """(init with a leading batch dim, whether one was added)."""
    if init.quat.ndim == 1:
        return Pose(init.quat[None], init.trans[None]), True
    return init, False


def _unbatch(res: ICPResult, squeeze: bool) -> ICPResult:
    if not squeeze:
        return res
    return ICPResult(Pose(res.transform.quat[0], res.transform.trans[0]),
                     res.fitness[0], res.converged[0])


@compiled.jit(static_argnames=("iterations", "trim_fraction", "transformation_eps"))
def icp_point2point(source, source_mask, target, target_mask, init: Pose,
                    max_corr_dist: float = 150.0, iterations: int = 20,
                    trim_fraction: float = 0.75, transformation_eps: float = 1e-6
                    ) -> ICPResult:
    """Brute-force-NN ICP. `init` may carry a leading batch dim [B] of
    seeds, run side by side over the same clouds. Per iteration only the
    correspondences at or below the `trim_fraction` quantile of squared NN
    distance are kept (1.0 disables trimming)."""
    init, squeeze = _batched(init)
    B, S = init.quat.shape[0], source.shape[0]
    max_d2 = max_corr_dist * max_corr_dist
    qmask = source_mask.repeat(B)

    def nn(pose):
        src_w = se3.apply(Pose(pose.quat[:, None], pose.trans[:, None]), source[None])
        d2, idx = voxel.nn1(src_w.reshape(-1, 3), qmask, target, target_mask)
        return d2.view(B, S), idx.view(B, S)

    def one_iter(pose):
        d2, idx = nn(pose)
        ok = source_mask[None] & (d2 < max_d2)
        if trim_fraction < 1.0:
            ok = ok & (d2 <= _quantile(torch.where(ok, d2, _TRIM_BIG), trim_fraction))
        return kabsch.kabsch_step(source, ok.to(torch.float32), target[idx], mask_q=False)

    pose = _run_iters(one_iter, init, iterations, transformation_eps)
    d2, _ = nn(pose)
    ok = source_mask[None] & (d2 < max_d2)
    n_ok = torch.sum(ok.to(torch.float32), dim=1)
    fitness = torch.sum(torch.where(ok, d2, 0.0), dim=1) / torch.clamp(n_ok, min=1.0)
    return _unbatch(ICPResult(pose, fitness, n_ok > 10), squeeze)


@compiled.jit(static_argnames=("gx", "gy", "gz", "cell_size", "reach", "iterations",
                               "transformation_eps"))
def icp_point2point_grid(source, source_mask, grid: gm.GridMap, gx: int, gy: int,
                         gz: int, cell_size: float, reach: float, init: Pose,
                         iterations: int = 20, transformation_eps: float = 1e-6
                         ) -> ICPResult:
    """ICP with the NN taken from the torus grid's neighbour cells
    (gridmap.knn_grid, k = 1) instead of a brute-force sweep.
    Correspondences are limited to `reach`; fitness averages over matched
    points and convergence also needs half the source matched."""
    init, squeeze = _batched(init)
    reach2 = reach * reach

    def nn(pose):
        src_w = se3.apply(Pose(pose.quat[0], pose.trans[0]), source)
        d2, nnp = gm.knn_grid(grid, src_w, source_mask, gx, gy, gz, cell_size, reach, 1)
        return d2[None, :, 0], nnp[None, :, 0, :]

    def one_iter(pose):
        d2, tgt_pts = nn(pose)
        ok = source_mask[None] & (d2 < reach2)
        return kabsch.kabsch_step(source, ok.to(torch.float32), tgt_pts, mask_q=True)

    if init.quat.shape[0] != 1:
        raise ValueError("icp_point2point_grid takes one initial pose")
    pose = _run_iters(one_iter, init, iterations, transformation_eps)
    d2, _ = nn(pose)
    has = source_mask[None] & (d2 < reach2)
    n_has = torch.sum(has.to(torch.float32), dim=1)
    n_src = torch.clamp(torch.sum(source_mask.to(torch.float32)), min=1.0)
    fitness = torch.sum(torch.where(has, d2, 0.0), dim=1) / torch.clamp(n_has, min=1.0)
    converged = (n_has > 10) & (n_has / n_src > 0.5)
    return _unbatch(ICPResult(pose, fitness, converged), squeeze)


@compiled.jit(static_argnames=(
    "voxel_size", "sub_capacity", "gx", "gy", "gz", "cell_size", "cell_cap", "dedup_radius",
    "reach", "max_corr_dist", "coarse_iterations", "fine_iterations", "transformation_eps"))
def verify_loop(src, src_mask, c_src, c_src_mask, c_tgt, c_tgt_mask, submap,
                submap_mask, inits: Pose, *, voxel_size: float, sub_capacity: int,
                gx: int, gy: int, gz: int, cell_size: float, cell_cap: int,
                dedup_radius: float, reach: float, max_corr_dist: float,
                coarse_iterations: int, fine_iterations: int,
                transformation_eps: float):
    """The two-stage loop verification: the submap's 0.4 m voxel filter and
    torus-grid load, both coarse seeds [2] side by side through brute-force
    ICP, the better-fitness winner through grid ICP at full density.
    Returns (fine ICPResult, coarse fitness [2]); nothing is read back."""
    sub_xyz, sub_mask, _ = voxel.voxel_downsample_packed(
        submap, submap_mask, voxel_size, capacity=sub_capacity, xy_bits=10, z_bits=9)
    grid = gm.insert(gm.init_grid(gx * gy * gz, cell_cap, submap.device), sub_xyz,
                     sub_mask, gx, gy, gz, cell_size, dedup_radius)
    coarse = icp_point2point(c_src, c_src_mask, c_tgt, c_tgt_mask, inits,
                             max_corr_dist=max_corr_dist, iterations=coarse_iterations,
                             transformation_eps=transformation_eps)
    use_b = coarse.fitness[1] < coarse.fitness[0]
    winner = Pose(torch.where(use_b, coarse.transform.quat[1], coarse.transform.quat[0]),
                  torch.where(use_b, coarse.transform.trans[1], coarse.transform.trans[0]))
    fine = icp_point2point_grid(src, src_mask, grid, gx, gy, gz, cell_size, reach, winner,
                                iterations=fine_iterations,
                                transformation_eps=transformation_eps)
    return fine, coarse.fitness
