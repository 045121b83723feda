"""The pose-graph optimise's Hessian-vector product in one launch a CG
step, on the card: a CUDA kernel (csrc/hess_matvec.cu) and its plain
version, the same IEEE operations in elementwise tensor ops.

`hess_matvec(odom, gps, loops, plans, v, damp, free)` is

    where(free, damp * v' + chain(v') + gps(v') + loops(v'), 0),
    v' = where(free, v, 0),

H v without forming H, over the sanitised factors of the graph
(models/posegraph.py `_FactorData`: odometry factor k joins nodes k and
k + 1, the GPS factor of node k has five zero rows, the loop factors join
`loops.i` and `loops.j`) and the loop plans of `segment_sum.plan`. For
every node the terms are added in one order, the reference's
(scaloam_tpu/models/posegraph.py:447-470): damp * v, Ji^T W A v of factor
k, Jj^T W A v of factor k - 1, the GPS term, the node's loop i-rows in
ascending row order, then its j-rows. Every 6-term product sums its terms
from the first to the last, one rounding a step.

Replaces no Pallas kernel: in the port this was ~30 launches a CG step
(two gathers, four einsums, shifts, two csrc/segment_sum.cu scatter-adds
and the two masks of the CG's matvec); the kernel is one.
"""

import ctypes

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops.kernels import _build, segment_sum


def hess_matvec(odom, gps, loops, plans, v: Tensor, damp: Tensor, free: Tensor) -> Tensor:
    """[N, 6] masked H v (see the module docstring); `plans` is the pair
    (plan of loops.i, plan of loops.j)."""
    return _hess_matvec_op(*operands(odom, gps, loops, plans, v, damp, free))


hess_matvec.launches = 0
_HMV = hess_matvec  # keeps the count while a caller swaps the module's name


def operands(odom, gps, loops, plans, v, damp, free):
    """hess_matvec's arguments as the kernel's 17 tensors, in the order of
    `hess_matvec_plain`."""
    (ord_i, st_i), (ord_j, st_j) = plans
    return (v, damp, free, odom.Ji, odom.Jj, odom.W, gps.Ji, gps.W, loops.Ji, loops.Jj, loops.W,
            loops.i.to(torch.int64), loops.j.to(torch.int64), ord_i, st_i, ord_j, st_j)


def mat_vec(J: Tensor, x: Tensor) -> Tensor:
    """J [F, 6, 6] times x [F, 6], the columns summed from the first."""
    acc = J[:, :, 0] * x[:, None, 0]
    for c in range(1, J.shape[2]):
        acc = acc + J[:, :, c] * x[:, None, c]
    return acc


def mat_t_vec(J: Tensor, y: Tensor) -> Tensor:
    """J^T y for J [F, 6, 6], y [F, 6], the rows summed from the first."""
    acc = J[:, 0, :] * y[:, 0, None]
    for r in range(1, J.shape[1]):
        acc = acc + J[:, r, :] * y[:, r, None]
    return acc


def hess_matvec_plain(v, damp, free, oJi, oJj, oW, gJ, gW, lJi, lJj, lW, li, lj,
                      ord_i, st_i, ord_j, st_j) -> Tensor:
    """The kernel's arithmetic in PyTorch ops."""
    fm = free[:, None]
    v = torch.where(fm, v, 0.0)
    v_next = torch.cat([v[1:], torch.zeros_like(v[:1])])
    WAv = oW * (mat_vec(oJi, v) + mat_vec(oJj, v_next))
    out = damp * v
    out = out + mat_t_vec(oJi, WAv)
    out = out + torch.cat([torch.zeros_like(v[:1]), mat_t_vec(oJj, WAv)[:-1]])
    out = out + mat_t_vec(gJ, gW * mat_vec(gJ, v))
    WAvl = lW * (mat_vec(lJi, v[li]) + mat_vec(lJj, v[lj]))
    out = segment_sum.add_plain(out, mat_t_vec(lJi, WAvl), ord_i, st_i)
    out = segment_sum.add_plain(out, mat_t_vec(lJj, WAvl), ord_j, st_j)
    return torch.where(fm, out, 0.0)


@torch.library.custom_op("scaloam::hess_matvec", mutates_args=(), device_types="cpu")
def _hess_matvec_op(v: Tensor, damp: Tensor, free: Tensor, oJi: Tensor, oJj: Tensor,
                    oW: Tensor, gJ: Tensor, gW: Tensor, lJi: Tensor, lJj: Tensor, lW: Tensor,
                    li: Tensor, lj: Tensor, ord_i: Tensor, st_i: Tensor, ord_j: Tensor,
                    st_j: Tensor) -> Tensor:
    return hess_matvec_plain(v, damp, free, oJi, oJj, oW, gJ, gW, lJi, lJj, lW, li, lj,
                             ord_i, st_i, ord_j, st_j)


@_hess_matvec_op.register_kernel("cuda")
def _hess_matvec_cuda(v, damp, free, oJi, oJj, oW, gJ, gW, lJi, lJj, lW, li, lj,
                      ord_i, st_i, ord_j, st_j):
    N, L, dev = v.shape[0], li.shape[0], v.device
    f32, i64 = torch.float32, torch.int64
    args = [v, damp, free, oJi, oJj, oW, gJ, gW, lJi, lJj, lW, li, lj, ord_i, st_i, ord_j, st_j]
    args = [a.contiguous() for a in args]
    for t, name, dtype, shape in zip(args, (
            "v", "damp", "free", "odom.Ji", "odom.Jj", "odom.W", "gps.Ji", "gps.W", "loops.Ji",
            "loops.Jj", "loops.W", "loops.i", "loops.j", "order_i", "starts_i", "order_j",
            "starts_j"), (f32, f32, torch.bool) + (f32,) * 8 + (i64,) * 6, (
            (N, 6), (N, 6), (N,), (N, 6, 6), (N, 6, 6), (N, 6), (N, 6, 6), (N, 6), (L, 6, 6),
            (L, 6, 6), (L, 6), (L,), (L,), (L,), (N + 1,), (L,), (N + 1,))):
        _build.check(t, name, dtype, shape, dev)
    out = torch.empty_like(args[0])
    if N == 0:
        return out
    fn = _build.library("hess_matvec").scaloam_hess_matvec
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(*(a.data_ptr() for a in args), N, out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"hess_matvec: CUDA launch failed with error {err}")
    compiled.count(_HMV)
    return out
