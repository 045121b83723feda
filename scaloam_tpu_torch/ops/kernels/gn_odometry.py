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

Each calls a custom op (`scaloam::associate_and_solve`,
`scaloam::gn_solve_prepared`) over a leading axis of P problems, which
launches the kernel's batched entry for CUDA tensors (P clusters in one
launch) and runs the plain version a problem for CPU tensors. The single
call is P = 1; under torch.func.vmap the ops' vmap rules fold the batch
into P, so a batch of B sequences is one launch, as the Pallas kernel
under jax.vmap is one call with a leading grid axis.
"""

import ctypes
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

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


def max_active_clusters(n_corner: int, n_surf: int, prepared: bool) -> int:
    """cudaOccupancyMaxActiveClusters for the cluster entry A or B launches
    at these point counts: a batch of more problems runs in waves."""
    fn = _lib().scaloam_gn_max_active_clusters
    fn.restype = _I
    fn.argtypes = [_I, _I, _I]
    n = fn(int(prepared), n_corner, n_surf)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with error {-n}")
    return n


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
    pose and the valid correspondence counts of the last pass. Under
    torch.func.vmap a batch of B problems is one launch of B clusters."""
    args = (c_xyz, c_any, c_other, c_mask, s_xyz, s_any, s_same, s_other, s_mask,
            quat0, trans0)
    quat, trans, counts = _assoc_op(*(a.unsqueeze(0) for a in args), outer_iterations,
                                    gn_iterations, float(thr), float(huber_delta),
                                    float(damping))
    return quat[0], trans[0], counts[0, 0], counts[0, 1]


associate_and_solve.launches = 0
_ASSOC = associate_and_solve  # keeps the count while a caller swaps the module's name


@torch.library.custom_op("scaloam::associate_and_solve", mutates_args=(), device_types="cpu")
def _assoc_op(c_xyz: Tensor, c_any: Tensor, c_other: Tensor, c_mask: Tensor,
              s_xyz: Tensor, s_any: Tensor, s_same: Tensor, s_other: Tensor,
              s_mask: Tensor, quat0: Tensor, trans0: Tensor, outer_iterations: int,
              gn_iterations: int, thr: float, huber_delta: float,
              damping: float) -> Tuple[Tensor, Tensor, Tensor]:
    """P problems (every argument with a leading [P]): quat [P, 4], trans
    [P, 3], counts int32 [P, 2]. On the CPU, the plain version a problem."""
    kw = dict(outer_iterations=outer_iterations, gn_iterations=gn_iterations, thr=thr,
              huber_delta=huber_delta, damping=damping)
    outs = [associate_and_solve_plain(*(a[p] for a in (
        c_xyz, c_any, c_other, c_mask, s_xyz, s_any, s_same, s_other, s_mask, quat0,
        trans0)), **kw) for p in range(c_xyz.shape[0])]
    return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
            torch.stack([torch.stack(o[2:]) for o in outs]))


@_assoc_op.register_kernel("cuda")
def _assoc_cuda(c_xyz, c_any, c_other, c_mask, s_xyz, s_any, s_same, s_other, s_mask,
                quat0, trans0, outer_iterations, gn_iterations, thr, huber_delta, damping):
    _check_gn_args("associate_and_solve", gn_iterations)
    dev = c_xyz.device
    P, Nc, Ns = c_xyz.shape[0], c_xyz.shape[1], s_xyz.shape[1]
    f32 = torch.float32
    _build.check(c_xyz, "c_xyz", f32, (P, Nc, 3), dev)
    _build.check(c_any, "c_any", f32, (P, Nc, 2, 3), dev)
    _build.check(c_other, "c_other", f32, (P, Nc, 2, 3), dev)
    _build.check(c_mask, "c_mask", torch.bool, (P, Nc), dev)
    _build.check(s_xyz, "s_xyz", f32, (P, Ns, 3), dev)
    _build.check(s_any, "s_any", f32, (P, Ns, 2, 3), dev)
    _build.check(s_same, "s_same", f32, (P, Ns, 2, 3), dev)
    _build.check(s_other, "s_other", f32, (P, Ns, 2, 3), dev)
    _build.check(s_mask, "s_mask", torch.bool, (P, Ns), dev)
    _build.check(quat0, "quat0", f32, (P, 4), dev)
    _build.check(trans0, "trans0", f32, (P, 3), dev)
    cluster_size(Nc, Ns, prepared=False)
    quat = torch.empty((P, 4), dtype=f32, device=dev)
    trans = torch.empty((P, 3), dtype=f32, device=dev)
    counts = torch.empty((P, 2), dtype=torch.int32, device=dev)
    fn = _lib().scaloam_gn_odometry_batched
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                   _F, _F, _F, _F, _P, _P, _P, _P]
    err = fn(
        P, c_xyz.data_ptr(), c_any.data_ptr(), c_other.data_ptr(), c_mask.data_ptr(), Nc,
        s_xyz.data_ptr(), s_any.data_ptr(), s_same.data_ptr(), s_other.data_ptr(),
        s_mask.data_ptr(), Ns, quat0.data_ptr(), trans0.data_ptr(),
        outer_iterations, gn_iterations, float(thr), float(huber_delta),
        _delta_sq(huber_delta), float(damping),
        quat.data_ptr(), trans.data_ptr(), counts.data_ptr(), _stream(dev),
    )
    if err:
        raise RuntimeError(f"associate_and_solve: CUDA launch failed with error {err}")
    _ASSOC.launches += 1
    return quat, trans, counts


@_assoc_op.register_vmap
def _assoc_vmap(info, in_dims, *args):
    """B batches of P problems are B * P problems of one call."""
    n = 11  # tensor arguments; the rest are the solve's settings
    folded = [_build.fold(t, d, info.batch_size) for t, d in zip(args[:n], in_dims[:n])]
    outs = _assoc_op(*folded, *args[n:])
    return tuple(_build.unfold(o, info.batch_size) for o in outs), (0, 0, 0)


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
    NaN. Returns (quat [4], trans [3]). Under torch.func.vmap a batch of B
    problems is one launch of B clusters."""
    args = (quat0, trans0, c_p, c_a, c_b, c_valid, s_p, s_n, s_neg_d, s_valid)
    quat, trans = _prepared_op(*(a.unsqueeze(0) for a in args), gn_iterations,
                               float(huber_delta), float(damping))
    return quat[0], trans[0]


gn_solve_prepared.launches = 0
_PREPARED = gn_solve_prepared  # keeps the count while a caller swaps the module's name


@torch.library.custom_op("scaloam::gn_solve_prepared", mutates_args=(), device_types="cpu")
def _prepared_op(quat0: Tensor, trans0: Tensor, c_p: Tensor, c_a: Tensor, c_b: Tensor,
                 c_valid: Tensor, s_p: Tensor, s_n: Tensor, s_neg_d: Tensor,
                 s_valid: Tensor, gn_iterations: int, huber_delta: float,
                 damping: float) -> Tuple[Tensor, Tensor]:
    """P problems (every argument with a leading [P]): quat [P, 4], trans
    [P, 3]. On the CPU, the plain version a problem."""
    kw = dict(gn_iterations=gn_iterations, huber_delta=huber_delta, damping=damping)
    outs = [gn_solve_prepared_plain(*(a[p] for a in (
        quat0, trans0, c_p, c_a, c_b, c_valid, s_p, s_n, s_neg_d, s_valid)), **kw)
        for p in range(c_p.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


@_prepared_op.register_kernel("cuda")
def _prepared_cuda(quat0, trans0, c_p, c_a, c_b, c_valid, s_p, s_n, s_neg_d, s_valid,
                   gn_iterations, huber_delta, damping):
    _check_gn_args("gn_solve_prepared", gn_iterations)
    dev = c_p.device
    P, Nc, Ns = c_p.shape[0], c_p.shape[1], s_p.shape[1]
    f32 = torch.float32
    for t, name in ((c_p, "c_p"), (c_a, "c_a"), (c_b, "c_b")):
        _build.check(t, name, f32, (P, Nc, 3), dev)
    _build.check(c_valid, "c_valid", torch.bool, (P, Nc), dev)
    _build.check(s_p, "s_p", f32, (P, Ns, 3), dev)
    _build.check(s_n, "s_n", f32, (P, Ns, 3), dev)
    _build.check(s_neg_d, "s_neg_d", f32, (P, Ns), dev)
    _build.check(s_valid, "s_valid", torch.bool, (P, Ns), dev)
    _build.check(quat0, "quat0", f32, (P, 4), dev)
    _build.check(trans0, "trans0", f32, (P, 3), dev)
    cluster_size(Nc, Ns, prepared=True)
    quat = torch.empty((P, 4), dtype=f32, device=dev)
    trans = torch.empty((P, 3), dtype=f32, device=dev)
    fn = _lib().scaloam_gn_solve_prepared_batched
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _F, _F, _F,
                   _P, _P, _P]
    err = fn(
        P, c_p.data_ptr(), c_a.data_ptr(), c_b.data_ptr(), c_valid.data_ptr(), Nc,
        s_p.data_ptr(), s_n.data_ptr(), s_neg_d.data_ptr(), s_valid.data_ptr(), Ns,
        quat0.data_ptr(), trans0.data_ptr(), gn_iterations, float(huber_delta),
        _delta_sq(huber_delta), float(damping), quat.data_ptr(), trans.data_ptr(),
        _stream(dev),
    )
    if err:
        raise RuntimeError(f"gn_solve_prepared: CUDA launch failed with error {err}")
    _PREPARED.launches += 1
    return quat, trans


@_prepared_op.register_vmap
def _prepared_vmap(info, in_dims, *args):
    """B batches of P problems are B * P problems of one call."""
    n = 10  # tensor arguments; the rest are the solve's settings
    folded = [_build.fold(t, d, info.batch_size) for t, d in zip(args[:n], in_dims[:n])]
    outs = _prepared_op(*folded, *args[n:])
    return tuple(_build.unfold(o, info.batch_size) for o in outs), (0, 0)


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
