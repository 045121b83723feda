"""Block-tridiagonal SPD solve by cyclic reduction, the pose-chain
preconditioner (counterpart of scaloam_tpu/ops/blocktri.py).

System: H x = b with H[i,i] = D[i] (6x6 SPD), H[i,i+1] = B[i] and
H[i+1,i] = B[i]^T. N is padded to a power of two with identity diagonal
blocks and zero coupling. log2(N) levels, each a batch of 6x6 eliminations
over the remaining blocks, held as [m, 6, 6] tensors (the reference's
structure-of-arrays lists of 36 vectors would cost a launch per entry
here). What changes results is kept: the pivot clamp sqrt(max(s, 1e-20))
of the 6x6 Cholesky, the identity padding, the per-level `reg` floor, and
the multi-RHS [N, 6, R] solve. Diagonal blocks are inverted at factor
time, and the factor is packed once (`Chain`), so that the solve, one
kernel launch a call on the card (ops/kernels/chain_solve.py), reads every
level from three contiguous buffers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scaloam_tpu_torch.ops.kernels import chain_solve


class Chain(NamedTuple):
    """The packed factor of an N-block chain, P = N padded to a power of
    two: level l (m = P >> (l + 1) blocks) at rows P - 2m .. P - m - 1."""

    Do_inv: torch.Tensor  # [P - 1, 6, 6] the levels' inverted odd diagonal blocks
    L: torch.Tensor  # [P - 1, 6, 6] coupling of odd block k to even block k
    R: torch.Tensor  # [P - 1, 6, 6] coupling of odd block k to even block k + 1
    root: torch.Tensor  # [6, 6] the inverse of the last reduced block


def _chol66(A: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 Cholesky [m, 6, 6] -> lower L, each pivot clamped at
    sqrt(1e-20) (a column at a time over the whole batch)."""
    L = torch.zeros_like(A)
    for j in range(6):
        Lj = L[:, j, :j]
        s = A[:, j, j] - torch.sum(Lj * Lj, dim=-1)
        Ljj = torch.sqrt(torch.clamp(s, min=1e-20))
        L[:, j, j] = Ljj
        if j < 5:
            col = A[:, j + 1:, j] - torch.matmul(L[:, j + 1:, :j], Lj[..., None])[..., 0]
            L[:, j + 1:, j] = col / Ljj[:, None]
    return L


def _inv66(A: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SPD 6x6 blocks through the clamped Cholesky."""
    L = _chol66(A)
    eye = torch.eye(6, dtype=A.dtype, device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(Linv.mT, Linv)


def factor(D: torch.Tensor, B: torch.Tensor, reg: float = 1e-5) -> Chain:
    """Cyclic-reduction factorization of (D [N, 6, 6], B [N, 6, 6]); B[i]
    couples (i, i+1) and B[N-1] is ignored. `reg` adds reg*mean(diag)*I to
    the reduced diagonal blocks after each level (caps the conditioning of
    the f32 Schur updates; as a preconditioner the bias is harmless)."""
    n = D.shape[0]
    size = 1
    while size < n:
        size *= 2
    B = B.clone()
    if size != n:
        pad = size - n
        eye = torch.eye(6, dtype=D.dtype, device=D.device).expand(pad, 6, 6)
        D = torch.cat([D, eye])
        B = torch.cat([B, B.new_zeros((pad, 6, 6))])
    B[n - 1:].zero_()  # decouple the last real block from the padding
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    levels = []
    while D.shape[0] > 1:
        Do, De = D[1::2], D[0::2]
        L, R = B[0::2], B[1::2]  # L[k] = B[2k], R[k] = B[2k+1]
        Do_inv = _inv66(Do)
        DiR = torch.matmul(Do_inv, R)
        D_new = De - torch.matmul(L, torch.matmul(Do_inv, L.mT))
        D_new[1:] -= torch.matmul(R.mT, DiR)[:-1]
        if reg:
            tr = torch.diagonal(D_new, dim1=-2, dim2=-1).sum(-1) * (reg / 6.0)
            D_new = D_new + tr[:, None, None] * eye6
        B_new = -torch.matmul(L, DiR)
        B_new[-1].zero_()
        levels.append((Do_inv, L, R))
        D, B = D_new, B_new
    if levels:  # packed once a factor, level 0 first
        Do_inv, L, R = (torch.cat(parts) for parts in zip(*levels))
    else:
        Do_inv = L = R = D.new_zeros((0, 6, 6))
    return Chain(Do_inv, L, R, _inv66(D)[0])


def solve(chain: Chain, b: torch.Tensor, free: torch.Tensor | None = None,
          mask_out: bool = False) -> torch.Tensor:
    """Solve H x = b from `factor`'s output: b [N, 6] -> [N, 6], or the
    multi-RHS [N, 6, R] -> [N, 6, R]; with `free`, rows where it is False
    enter as 0 and, with `mask_out`, leave as 0 (chain_solve.chain_solve)."""
    return chain_solve.chain_solve(chain, b, free, mask_out)


def solve_tridiag(D: torch.Tensor, B: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-shot factor + solve."""
    return solve(factor(D, B), b)
