"""Gauss-Newton pose solves on the card: CUDA kernel K2 (two entry points)
and their plain versions.

The kernel is csrc/gn_odometry.cu: one thread-block cluster (at most 8
blocks, the size picked from the point counts) stages its inputs into
shared memory once and runs a GN core over prepared point-to-line and
point-to-plane factors, reducing across the cluster through distributed
shared memory; what bounds it on the card and what its design does about
that is noted there. Inputs are tensors of points (the TPU's 16- and
24-row packs are not kept).

- `associate_and_solve` (entry A) replaces the TPU kernel
  scaloam_tpu/ops/pallas/gn_odometry.py:associate_and_solve: per outer pass
  it re-ranks cached candidates, prepares the factors, then runs the core.
  Its plain version is the odometry model's _associate + _solve loop.
- `gn_solve_prepared` (entry B) replaces mapping's GN loop
  (scaloam_tpu/models/mapping.py:187 over scaloam_tpu/ops/gn.py): the core
  alone over factors the caller prepared. Its plain version is
  gn.gauss_newton over residuals.edge_factors_from_prep and
  plane_norm_factors_T.

Each launches the kernel for CUDA tensors and takes its plain version for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scaloam_tpu_torch.ops import gn, residuals
from scaloam_tpu_torch.ops.kernels import _build
from scaloam_tpu_torch.types import Pose

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    return _build.library("gn_odometry")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _delta_sq(huber_delta: float) -> float:
    return float(np.float32(huber_delta) * np.float32(huber_delta))


def cluster_size(n_corner: int, n_surf: int, prepared: bool) -> int:
    """Blocks in the cluster that entry A (prepared=False) or entry B
    (prepared=True) launches for these point counts; raises if the points
    do not fit in the shared memory of 8 blocks."""
    fn = _lib().scaloam_gn_cluster_size
    fn.restype = _I
    fn.argtypes = [_I, _I, _I]
    c = fn(int(prepared), n_corner, n_surf)
    if c < 1:
        raise ValueError(f"gn kernel: {n_corner} corner + {n_surf} surf points do not fit "
                         "in the shared memory of one cluster")
    return c


def _check_gn_args(name: str, gn_iterations: int) -> None:
    if gn_iterations < 1:
        raise ValueError(f"{name}: the kernel needs gn_iterations >= 1, got {gn_iterations}")


def associate_and_solve(c_xyz, c_any, c_other, c_mask,
                        s_xyz, s_any, s_same, s_other, s_mask,
                        quat0, trans0, *, outer_iterations: int,
                        gn_iterations: int, thr: float, huber_delta: float,
                        damping: float = 1e-6):
    """Corner points c_xyz [Nc, 3] with candidate pairs c_any/c_other
    [Nc, 2, 3] and mask [Nc]; surf points s_xyz [Ns, 3] with s_any/s_same/
    s_other [Ns, 2, 3] and mask [Ns]; initial pose quat0 [4], trans0 [3].
    Returns (quat [4], trans [3], n_corner int32, n_surf int32): the solved
    pose and the valid correspondence counts of the last pass."""
    kw = dict(outer_iterations=outer_iterations, gn_iterations=gn_iterations,
              thr=thr, huber_delta=huber_delta, damping=damping)
    if c_xyz.device.type == "cpu":
        return associate_and_solve_plain(c_xyz, c_any, c_other, c_mask, s_xyz,
                                         s_any, s_same, s_other, s_mask,
                                         quat0, trans0, **kw)
    if c_xyz.device.type != "cuda":
        raise ValueError(f"associate_and_solve: unsupported device {c_xyz.device}")
    _check_gn_args("associate_and_solve", gn_iterations)
    dev = c_xyz.device
    Nc, Ns = c_xyz.shape[0], s_xyz.shape[0]
    f32 = torch.float32
    _build.check(c_xyz, "c_xyz", f32, (Nc, 3), dev)
    _build.check(c_any, "c_any", f32, (Nc, 2, 3), dev)
    _build.check(c_other, "c_other", f32, (Nc, 2, 3), dev)
    _build.check(c_mask, "c_mask", torch.bool, (Nc,), dev)
    _build.check(s_xyz, "s_xyz", f32, (Ns, 3), dev)
    _build.check(s_any, "s_any", f32, (Ns, 2, 3), dev)
    _build.check(s_same, "s_same", f32, (Ns, 2, 3), dev)
    _build.check(s_other, "s_other", f32, (Ns, 2, 3), dev)
    _build.check(s_mask, "s_mask", torch.bool, (Ns,), dev)
    _build.check(quat0, "quat0", f32, (4,), dev)
    _build.check(trans0, "trans0", f32, (3,), dev)
    cluster_size(Nc, Ns, prepared=False)
    quat = torch.empty(4, dtype=f32, device=dev)
    trans = torch.empty(3, dtype=f32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    fn = _lib().scaloam_gn_odometry
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                   _F, _F, _F, _F, _P, _P, _P, _P]
    err = fn(
        c_xyz.data_ptr(), c_any.data_ptr(), c_other.data_ptr(), c_mask.data_ptr(), Nc,
        s_xyz.data_ptr(), s_any.data_ptr(), s_same.data_ptr(), s_other.data_ptr(),
        s_mask.data_ptr(), Ns, quat0.data_ptr(), trans0.data_ptr(),
        outer_iterations, gn_iterations, float(thr), float(huber_delta),
        _delta_sq(huber_delta), float(damping),
        quat.data_ptr(), trans.data_ptr(), counts.data_ptr(), _stream(dev),
    )
    if err:
        raise RuntimeError(f"associate_and_solve: CUDA launch failed with error {err}")
    associate_and_solve.launches += 1
    return quat, trans, counts[0], counts[1]


associate_and_solve.launches = 0


def associate_and_solve_plain(c_xyz, c_any, c_other, c_mask,
                              s_xyz, s_any, s_same, s_other, s_mask,
                              quat0, trans0, *, outer_iterations: int,
                              gn_iterations: int, thr: float,
                              huber_delta: float, damping: float = 1e-6):
    """What entry A fuses: outer_iterations passes of the odometry model's
    _associate (candidate re-rank) and _solve (GN)."""
    from scaloam_tpu_torch.models import odometry  # imports this module

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
    """GN over prepared factors: point-to-line (points c_p [Nc, 3] on the
    lines through c_a, c_b [Nc, 3], mask c_valid [Nc]) and point-to-plane
    (points s_p [Ns, 3], unit normals s_n [Ns, 3], offsets s_neg_d [Ns],
    mask s_valid [Ns]), from quat0 [4], trans0 [3]. Invalid rows may hold
    NaN. Returns (quat [4], trans [3])."""
    kw = dict(gn_iterations=gn_iterations, huber_delta=huber_delta, damping=damping)
    if c_p.device.type == "cpu":
        return gn_solve_prepared_plain(quat0, trans0, c_p, c_a, c_b, c_valid,
                                       s_p, s_n, s_neg_d, s_valid, **kw)
    if c_p.device.type != "cuda":
        raise ValueError(f"gn_solve_prepared: unsupported device {c_p.device}")
    _check_gn_args("gn_solve_prepared", gn_iterations)
    dev = c_p.device
    Nc, Ns = c_p.shape[0], s_p.shape[0]
    f32 = torch.float32
    for t, name in ((c_p, "c_p"), (c_a, "c_a"), (c_b, "c_b")):
        _build.check(t, name, f32, (Nc, 3), dev)
    _build.check(c_valid, "c_valid", torch.bool, (Nc,), dev)
    _build.check(s_p, "s_p", f32, (Ns, 3), dev)
    _build.check(s_n, "s_n", f32, (Ns, 3), dev)
    _build.check(s_neg_d, "s_neg_d", f32, (Ns,), dev)
    _build.check(s_valid, "s_valid", torch.bool, (Ns,), dev)
    _build.check(quat0, "quat0", f32, (4,), dev)
    _build.check(trans0, "trans0", f32, (3,), dev)
    cluster_size(Nc, Ns, prepared=True)
    quat = torch.empty(4, dtype=f32, device=dev)
    trans = torch.empty(3, dtype=f32, device=dev)
    fn = _lib().scaloam_gn_solve_prepared
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _F, _F, _F,
                   _P, _P, _P]
    err = fn(
        c_p.data_ptr(), c_a.data_ptr(), c_b.data_ptr(), c_valid.data_ptr(), Nc,
        s_p.data_ptr(), s_n.data_ptr(), s_neg_d.data_ptr(), s_valid.data_ptr(), Ns,
        quat0.data_ptr(), trans0.data_ptr(), gn_iterations, float(huber_delta),
        _delta_sq(huber_delta), float(damping), quat.data_ptr(), trans.data_ptr(),
        _stream(dev),
    )
    if err:
        raise RuntimeError(f"gn_solve_prepared: CUDA launch failed with error {err}")
    gn_solve_prepared.launches += 1
    return quat, trans


gn_solve_prepared.launches = 0


def gn_solve_prepared_plain(quat0, trans0, c_p, c_a, c_b, c_valid,
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
