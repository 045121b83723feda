"""The pose-chain preconditioner's block-tridiagonal solve in one launch a
call on the card: a CUDA kernel (csrc/chain_solve.cu) and its plain
version, the same IEEE operations in elementwise tensor ops.

`chain_solve(chain, b, free=None, mask_out=False)` is

    x = solve(chain, where(free, b, 0)),  then where(free, x, 0) if mask_out

by cyclic reduction over `chain`, the packed factor of ops/blocktri.py
(`factor`), for b [n, 6] or the multi-right-hand-side [n, 6, C]. The
pose graph's chain-CG preconditioner masks both sides, the Woodbury one
only the input, the Woodbury setup neither (models/posegraph.py).

Order of operations, the port's at every level (level l's blocks at rows
P - (P >> l) .. of the packed buffers, P = n padded to a power of two):
forward t = Do_inv bo, x = be - L t, then x[k] -= R[k-1]^T t[k-1] for
k >= 1; the root x = root_inv x; back rhs = bo - L^T x, then rhs[k] -=
R[k] x[k+1] for every k but the last, x_odd = Do_inv rhs. Every 6-term
product sums its terms from the first, one rounding a step, as the
reference's `_mv66` (scaloam_tpu/ops/blocktri.py:68-75).

Replaces no Pallas kernel: in the port this was ~90 launches a call at 256
nodes (the batched matmuls, subtractions, slice updates and stacks of 8
levels down and 8 up, and the masks); the kernel is one.
"""

import ctypes
from typing import Optional

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops.kernels import _build


def chain_solve(chain, b: Tensor, free: Optional[Tensor] = None,
                mask_out: bool = False) -> Tensor:
    """solve(chain, where(free, b, 0)) for b [n, 6] or [n, 6, C], masked by
    free after the solve too where mask_out (module docstring)."""
    if mask_out and free is None:
        raise ValueError("chain_solve: mask_out needs free")
    vec = b.dim() == 2
    out = _chain_solve_op(*chain, (b[..., None] if vec else b).contiguous(), free, mask_out)
    return out[..., 0] if vec else out


chain_solve.launches = 0
_CHAIN_SOLVE = chain_solve  # keeps the count while a caller swaps the module's name


def mat_vec(M: Tensor, x: Tensor) -> Tensor:
    """M [m, 6, 6] times x [m, 6, C] -> [m, 6, C], each row's six products
    summed from the first."""
    p = M[..., None] * x[:, None]  # [m, 6, 6, C]
    acc = p[:, :, 0]
    for j in range(1, 6):
        acc = acc + p[:, :, j]
    return acc


def chain_solve_plain(Do_inv, L, R, root, b, free, mask_out: bool) -> Tensor:
    """The kernel's arithmetic in PyTorch ops, b [n, 6, C]."""
    n, P = b.shape[0], Do_inv.shape[0] + 1
    x = b if free is None else torch.where(free[:, None, None], b, 0.0)
    x = torch.cat([x, x.new_zeros((P - n,) + x.shape[1:])])
    levels, off, m = [], 0, P // 2
    while m >= 1:
        levels.append((Do_inv[off:off + m], L[off:off + m], R[off:off + m]))
        off, m = off + m, m // 2
    stack = []
    for D, Lm, Rm in levels:
        bo, be = x[1::2], x[0::2]
        t = mat_vec(D, bo)
        x = be - mat_vec(Lm, t)
        x[1:] -= mat_vec(Rm[:-1].mT, t[:-1])
        stack.append(bo)
    x = mat_vec(root[None], x)
    for (D, Lm, Rm), bo in zip(reversed(levels), reversed(stack)):
        rhs = bo - mat_vec(Lm.mT, x)
        rhs[:-1] -= mat_vec(Rm[:-1], x[1:])
        xo = mat_vec(D, rhs)
        x = torch.stack([x, xo], dim=1).reshape((2 * x.shape[0],) + x.shape[1:])
    x = x[:n]
    return torch.where(free[:, None, None], x, 0.0) if mask_out else x


@torch.library.custom_op("scaloam::chain_solve", mutates_args=(), device_types="cpu")
def _chain_solve_op(Do_inv: Tensor, L: Tensor, R: Tensor, root: Tensor, b: Tensor,
                    free: Optional[Tensor], mask_out: bool) -> Tensor:
    return chain_solve_plain(Do_inv, L, R, root, b, free, mask_out)


@_chain_solve_op.register_kernel("cuda")
def _chain_solve_cuda(Do_inv, L, R, root, b, free, mask_out):
    n, C, dev = b.shape[0], b.shape[2], b.device
    P = Do_inv.shape[0] + 1
    if P & (P - 1) or n > P:
        raise ValueError(f"chain_solve: {P} padded nodes for {n} rows")
    f32 = torch.float32
    for t, name, shape in ((Do_inv, "Do_inv", (P - 1, 6, 6)), (L, "L", (P - 1, 6, 6)),
                           (R, "R", (P - 1, 6, 6)), (root, "root", (6, 6)), (b, "b", (n, 6, C))):
        _build.check(t, name, f32, shape, dev)
    if free is not None:
        _build.check(free, "free", torch.bool, (n,), dev)
    out = torch.empty_like(b)
    fn = _build.library("chain_solve").scaloam_chain_solve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2
    err = fn(Do_inv.data_ptr(), L.data_ptr(), R.data_ptr(), root.data_ptr(), P, b.data_ptr(), n,
             C, None if free is None else free.data_ptr(), int(mask_out), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chain_solve: CUDA launch failed with error {err}")
    compiled.count(_CHAIN_SOLVE)
    return out
