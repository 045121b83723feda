"""Scan-to-scan associate + Gauss-Newton solve: CUDA kernel K2 and its
plain version.

Replaces the TPU kernel scaloam_tpu/ops/pallas/gn_odometry.py:
associate_and_solve. The kernel is csrc/gn_odometry.cu (one thread block
running all 2 x 4 iterations); what bounds it on the card and what its
design does about that is noted there. Inputs are the feature points and
their cached candidate pairs as tensors of points (the TPU's 16- and
24-row packs are not kept). `associate_and_solve` launches the kernel for
CUDA tensors and takes `associate_and_solve_plain` (the odometry model's
_associate + _solve loop) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scaloam_tpu_torch.ops.kernels import _build
from scaloam_tpu_torch.types import Pose


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
    lib = _build.library("gn_odometry")
    quat = torch.empty(4, dtype=f32, device=dev)
    trans = torch.empty(3, dtype=f32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    choice = torch.empty(Nc + Ns, dtype=torch.uint8, device=dev)  # scratch
    fn = lib.scaloam_gn_odometry
    fn.restype = ctypes.c_int
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, P, I, P, P, P, P, P, I, P, P, I, I, F, F, F, F,
                   P, P, P, P, P]
    err = fn(
        c_xyz.data_ptr(), c_any.data_ptr(), c_other.data_ptr(), c_mask.data_ptr(), Nc,
        s_xyz.data_ptr(), s_any.data_ptr(), s_same.data_ptr(), s_other.data_ptr(),
        s_mask.data_ptr(), Ns, quat0.data_ptr(), trans0.data_ptr(),
        outer_iterations, gn_iterations, float(thr), float(huber_delta),
        float(np.float32(huber_delta) * np.float32(huber_delta)), float(damping),
        choice.data_ptr(), quat.data_ptr(), trans.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
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
    """What the kernel fuses: outer_iterations passes of the odometry
    model's _associate (candidate re-rank) and _solve (GN)."""
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
