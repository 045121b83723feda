"""Batched Gauss-Newton on SE(3) (counterpart of scaloam_tpu/ops/gn.py).

Normal equations are accumulated over all factors at once (SoA or AoS); a robust
Huber reweight per factor block, a fixed iteration count and a tiny
diagonal damping replace Ceres' DENSE_QR solve.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from reference.slam.ops import residuals as res_mod
from reference.slam.ops import se3
from reference.slam.types import Pose


def huber_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Ceres HuberLoss rho'(s) at s = ||r||^2: 1 for s <= delta^2,
    delta/sqrt(s) beyond."""
    safe = torch.clamp(sq_norm, min=1e-20)
    return torch.where(sq_norm <= delta * delta, 1.0, delta / torch.sqrt(safe))


def normal_equations(
    factor_sets: Sequence[res_mod.FactorSetT], huber_delta: float | None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accumulate JtJ [6,6], Jtr [6] and total weighted cost over factor
    sets, SoA (FactorSetT: r [R, n], J [R, 6, n]) or AoS (FactorSet:
    r [n, R], J [n, R, 6])."""
    dev = factor_sets[0].r.device
    JtJ = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    Jtr = torch.zeros((6,), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for fs in factor_sets:
        if isinstance(fs, res_mod.FactorSet):
            vm = fs.valid[:, None]
            r = torch.where(vm, fs.r, 0.0)
            J = torch.where(vm[..., None], fs.J, 0.0)
            s = torch.sum(r * r, dim=-1)
            w = fs.valid.to(torch.float32)
            if huber_delta is not None:
                w = w * huber_weight(s, huber_delta)
            Jw = J * w[:, None, None]
            JtJ = JtJ + torch.einsum("nri,nrj->ij", Jw, J)
            Jtr = Jtr + torch.einsum("nri,nr->i", Jw, r)
            cost = cost + torch.sum(w * s)
            continue
        # where, not multiply: degenerate rows can carry NaN/inf and
        # 0 * NaN would poison the sums.
        vm = fs.valid[None, :]
        r = torch.where(vm, fs.r, 0.0)
        J = torch.where(vm[:, None, :], fs.J, 0.0)
        s = torch.sum(r * r, dim=0)  # [n]
        w = fs.valid.to(torch.float32)
        if huber_delta is not None:
            w = w * huber_weight(s, huber_delta)
        Jw = J * w[None, None, :]
        JtJ = JtJ + torch.einsum("rin,rjn->ij", Jw, J)
        Jtr = Jtr + torch.einsum("rin,rn->i", Jw, r)
        cost = cost + torch.sum(w * s)
    return JtJ, Jtr, cost


def cholesky_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a 6x6 SPD system: the reference's unrolled
    Cholesky (pivots clamped at 1e-20), one column at a time."""
    n = 6
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[j:, j]
        if j:
            s = s - torch.sum(L[j:, :j] * L[j, :j], dim=1)
        Ljj = torch.sqrt(torch.clamp(s[0], min=1e-20))
        L[j, j] = Ljj
        L[j + 1 :, j] = s[1:] * (1.0 / Ljj)
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - torch.sum(L[i, :i] * y[:i])) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - torch.sum(L[i + 1 :, i] * x[i + 1 :])) / L[i, i]
    return x


def solve_step(JtJ: torch.Tensor, Jtr: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """One GN step: (JtJ + lambda*diag(JtJ)) delta = -Jtr."""
    diag = torch.diagonal(JtJ)
    A = JtJ + damping * torch.diag(torch.clamp(diag, min=1e-8))
    return cholesky_solve6(A, -Jtr)


def apply_delta(pose: Pose, delta: torch.Tensor) -> Pose:
    """Right-multiplicative update matching the residual Jacobians."""
    dq = se3.exp_so3(delta[:3])
    return Pose(
        se3.quat_normalize(se3.quat_mul(pose.quat, dq)), pose.trans + delta[3:]
    )


def gauss_newton(pose0: Pose, build_factors, iterations: int,
                 huber_delta: float | None, damping: float = 1e-6) -> Pose:
    """Fixed-count GN: factors are relinearized each iteration from the
    current pose with frozen correspondences."""
    pose = pose0
    for _ in range(iterations):
        sets = build_factors(pose)
        JtJ, Jtr, _ = normal_equations(sets, huber_delta)
        delta = solve_step(JtJ, Jtr, damping)
        pose = apply_delta(pose, delta)
    return pose
