"""Pose-graph backend: batch damped Gauss-Newton over the whole graph
(counterpart of scaloam_tpu/models/posegraph.py).

Factors: odometry BetweenFactors along the chain (variances rot 1e-6 /
trans 1e-4), ScanContext loop BetweenFactors with Cauchy(k) robust
weights, and altitude-only GPS factors. Node 0 is frozen (the reference's
1e-12-variance prior). Each GN step solves H d = -g by conjugate gradients
without forming H: the matvec is one fused kernel a CG step
(ops/kernels/hess_matvec.py), and the gradient's and diagonal's loop
rows go through fixed-order segment sums (ops/kernels/segment_sum.py):
each node adds its loop rows in ascending order, as the reference's
`.at[].add` does, so an optimise on the card gives one answer for one
input. The preconditioner is the
exact block-tridiagonal chain (ops/blocktri.py) or, on the Woodbury tier,
the Woodbury inverse of chain + low-rank loop terms. The solver choice is
static, from the padded capacities and the PGOConfig thresholds.

Per-factor Jacobians are exact: torch.func.jacrev of the tangent residual,
vmapped over factors. The GN and CG loops are Python loops with no read of
the device inside; the graph's capacities grow in tiers (doubling), with
the node and loop counts tracked on the host by the caller.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scaloam_tpu_torch import compiled, device as _device
from scaloam_tpu_torch.config import PGOConfig
from scaloam_tpu_torch.ops import blocktri, se3
from scaloam_tpu_torch.ops.kernels import hess_matvec, segment_sum
from scaloam_tpu_torch.types import Pose


class PoseGraph(NamedTuple):
    poses: Pose  # [N] current estimates
    odom_poses: Pose  # [N] raw odometry poses (the odom_poses artifact)
    n_nodes: torch.Tensor  # int32 scalar
    odom_rel: Pose  # [N]: factor k connects (k, k+1)
    loop_i: torch.Tensor  # [L] int64 (curr)
    loop_j: torch.Tensor  # [L] int64 (loop target)
    loop_rel: Pose  # [L] Z with X_i^-1 X_j ~= Z
    n_loops: torch.Tensor  # int32 scalar
    gps_z: torch.Tensor  # [N]
    gps_valid: torch.Tensor  # [N] bool
    # Node k starts a new sequence: factor (k-1 -> k) is invalid and the
    # chain preconditioner's coupling is zero there.
    chain_break: torch.Tensor  # [N] bool


def init_graph(cfg: PGOConfig, device, initial_nodes: int = 256,
               initial_loops: int = 64) -> PoseGraph:
    N = min(cfg.max_keyframes, initial_nodes)
    L = min(cfg.max_loops, initial_loops)
    z32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return PoseGraph(
        poses=Pose.identity(device, (N,)),
        odom_poses=Pose.identity(device, (N,)),
        n_nodes=z32(),
        odom_rel=Pose.identity(device, (N,)),
        loop_i=torch.zeros((L,), dtype=torch.int64, device=device),
        loop_j=torch.zeros((L,), dtype=torch.int64, device=device),
        loop_rel=Pose.identity(device, (L,)),
        n_loops=z32(),
        gps_z=torch.zeros((N,), dtype=torch.float32, device=device),
        gps_valid=torch.zeros((N,), dtype=torch.bool, device=device),
        chain_break=torch.zeros((N,), dtype=torch.bool, device=device),
    )


def node_capacity(graph: PoseGraph) -> int:
    return graph.gps_z.shape[0]


def loop_capacity(graph: PoseGraph) -> int:
    return graph.loop_i.shape[0]


def grow(graph: PoseGraph, node_capacity_new: int | None = None,
         loop_capacity_new: int | None = None) -> PoseGraph:
    """The graph at larger capacities, contents kept."""
    N, L = node_capacity(graph), loop_capacity(graph)
    nN = N if node_capacity_new is None else node_capacity_new
    nL = L if loop_capacity_new is None else loop_capacity_new
    if nN < N or nL < L:
        raise ValueError(f"grow cannot shrink: ({N},{L}) -> ({nN},{nL})")
    if nN == N and nL == L:
        return graph
    dev = graph.gps_z.device

    def pad_pose(p: Pose, extra: int) -> Pose:
        if extra == 0:
            return p
        ident = Pose.identity(dev, (extra,))
        return Pose(torch.cat([p.quat, ident.quat]), torch.cat([p.trans, ident.trans]))

    def pad(a: torch.Tensor, extra: int) -> torch.Tensor:
        if extra == 0:
            return a
        return torch.cat([a, a.new_zeros((extra,) + a.shape[1:])])

    dN, dL = nN - N, nL - L
    compiled.drop(graph)  # no step replays this tier again
    return graph._replace(
        poses=pad_pose(graph.poses, dN), odom_poses=pad_pose(graph.odom_poses, dN),
        odom_rel=pad_pose(graph.odom_rel, dN), gps_z=pad(graph.gps_z, dN),
        gps_valid=pad(graph.gps_valid, dN), chain_break=pad(graph.chain_break, dN),
        loop_i=pad(graph.loop_i, dL), loop_j=pad(graph.loop_j, dL),
        loop_rel=pad_pose(graph.loop_rel, dL),
    )


def ensure_node_slot(graph: PoseGraph, n_nodes_host: int) -> PoseGraph:
    """Grow (2x) if appending node #n_nodes_host would exceed capacity."""
    cap = node_capacity(graph)
    if n_nodes_host >= cap:
        return grow(graph, node_capacity_new=max(2 * cap, n_nodes_host + 1))
    return graph


def ensure_loop_slot(graph: PoseGraph, n_loops_host: int) -> PoseGraph:
    cap = loop_capacity(graph)
    if n_loops_host >= cap:
        return grow(graph, loop_capacity_new=max(2 * cap, n_loops_host + 1))
    return graph


def _row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a one-element index tensor i, read on the device."""
    return a.index_select(0, i)[0]


@compiled.jit(static_argnames=("new_sequence",), donate_argnums=(0,))
def add_keyframe_jit(graph: PoseGraph, odom_pose: Pose, gps_z: torch.Tensor,
                     gps_valid: torch.Tensor, new_sequence: bool = False) -> PoseGraph:
    """Append a node at slot min(n_nodes, capacity - 1), read on the
    device, and write the tables in place. The factor to the previous node
    is the odometry increment; the new estimate is the previous estimate
    composed with it (a warm start). A node that starts a sequence anchors
    at its own odometry pose. Clamps at capacity: reserve a slot first
    (ensure_node_slot with a host-tracked count), or call `add_keyframe`."""
    i = torch.clamp(graph.n_nodes, max=node_capacity(graph) - 1).to(torch.int64).reshape(1)
    first = (graph.n_nodes == 0) | new_sequence
    prev = torch.clamp(i - 1, min=0)
    rel = se3.relative(Pose(_row(graph.odom_poses.quat, prev), _row(graph.odom_poses.trans, prev)),
                       odom_pose)
    chained = se3.compose(Pose(_row(graph.poses.quat, prev), _row(graph.poses.trans, prev)), rel)
    est = Pose(torch.where(first, odom_pose.quat, chained.quat),
               torch.where(first, odom_pose.trans, chained.trans))
    graph.chain_break.index_fill_(0, i, bool(new_sequence))
    for table, at, value in ((graph.poses.quat, i, est.quat), (graph.poses.trans, i, est.trans),
                             (graph.odom_poses.quat, i, odom_pose.quat),
                             (graph.odom_poses.trans, i, odom_pose.trans),
                             (graph.odom_rel.quat, prev, rel.quat),
                             (graph.odom_rel.trans, prev, rel.trans),
                             (graph.gps_z, i, gps_z), (graph.gps_valid, i, gps_valid)):
        table.index_copy_(0, at, value.reshape((1,) + table.shape[1:]).to(table.dtype))
    graph.n_nodes.add_(1)
    return graph


@compiled.jit(donate_argnums=(0,))
def add_loop_jit(graph: PoseGraph, i: torch.Tensor, j: torch.Tensor, rel: Pose) -> PoseGraph:
    """Append a loop factor at slot min(n_loops, capacity - 1), read on the
    device, in place. Clamps at capacity: reserve with ensure_loop_slot
    first, or call `add_loop`."""
    k = torch.clamp(graph.n_loops, max=loop_capacity(graph) - 1).to(torch.int64).reshape(1)
    for table, value in ((graph.loop_i, i), (graph.loop_j, j), (graph.loop_rel.quat, rel.quat),
                         (graph.loop_rel.trans, rel.trans)):
        table.index_copy_(0, k, value.reshape((1,) + table.shape[1:]).to(table.dtype))
    graph.n_loops.add_(1)
    return graph


def _device_scalars(device, dtype, *values) -> list:
    """Each value as a 0-dim tensor on `device`: tensors moved there, the
    host numbers (as numpy `dtype`) in one pinned, asynchronous upload. A
    compiled step keys on a host number's value, and a capture would bake
    it into the graph."""
    host = [k for k, v in enumerate(values) if not isinstance(v, torch.Tensor)]
    up = _device.upload(np.array([values[k] for k in host], dtype), device) if host else None
    out = [v.to(device) if isinstance(v, torch.Tensor) else None for v in values]
    for n, k in enumerate(host):
        out[k] = up[n]
    return out


def add_keyframe(graph: PoseGraph, odom_pose: Pose, gps_z, gps_valid, *,
                 n_nodes: int | None = None, new_sequence: bool = False) -> PoseGraph:
    """Grow the node tier on demand, then append (add_keyframe_jit). Pass
    the host-tracked `n_nodes` to skip reading graph.n_nodes from the
    device. The graph's tables are written in place."""
    n = int(graph.n_nodes) if n_nodes is None else n_nodes
    graph = ensure_node_slot(graph, n)
    z, ok = _device_scalars(graph.gps_z.device, np.float32, gps_z, gps_valid)
    return add_keyframe_jit(graph, odom_pose, z, ok, new_sequence=bool(new_sequence))


def add_loop(graph: PoseGraph, i, j, rel: Pose, *, n_loops: int | None = None) -> PoseGraph:
    """Grow the loop tier on demand, then append (add_loop_jit), in place."""
    n = int(graph.n_loops) if n_loops is None else n_loops
    graph = ensure_loop_slot(graph, n)
    i, j = _device_scalars(graph.loop_i.device, np.int64, i, j)
    return add_loop_jit(graph, i, j, rel)


# ---------------------------------------------------------------------------
# Residuals + Jacobians
# ---------------------------------------------------------------------------


def _between_residual(xi: Pose, xj: Pose, z: Pose) -> torch.Tensor:
    """r = Log(Z^-1 (X_i^-1 X_j)), (omega, v) ordering."""
    return se3.log_se3(se3.compose(se3.inverse(z), se3.relative(xi, xj)))


def _between_perturbed(di, dj, xq, xt, yq, yt, zq, zt):
    r = _between_residual(
        se3.compose(Pose(xq, xt), se3.exp_se3(di)),
        se3.compose(Pose(yq, yt), se3.exp_se3(dj)),
        Pose(zq, zt),
    )
    return r, r


def _gps_perturbed(d, xq, xt, z):
    r = se3.compose(Pose(xq, xt), se3.exp_se3(d)).trans[2:3] - z[None]
    return r, r


_between_jac = torch.func.vmap(
    torch.func.jacrev(_between_perturbed, argnums=(0, 1), has_aux=True),
    in_dims=(None, None, 0, 0, 0, 0, 0, 0),
)
_gps_jac = torch.func.vmap(
    torch.func.jacrev(_gps_perturbed, argnums=0, has_aux=True), in_dims=(None, 0, 0, 0)
)


def _between_batch(xi: Pose, xj: Pose, z: Pose):
    """Residuals [F, 6] and Jacobians [F, 6, 6] wrt right perturbations of
    X_i and X_j."""
    zero = xi.quat.new_zeros(6)
    (Ji, Jj), r = _between_jac(zero, zero, xi.quat, xi.trans, xj.quat, xj.trans,
                               z.quat, z.trans)
    return r, Ji, Jj


def _gps_batch(x: Pose, z: torch.Tensor):
    """Altitude residuals [F, 1] and Jacobians [F, 1, 6]."""
    J, r = _gps_jac(x.quat.new_zeros(6), x.quat, x.trans, z)
    return r, J


def cauchy_weight(sq_whitened: torch.Tensor, k: float) -> torch.Tensor:
    """gtsam mEstimator::Cauchy(k): w = k^2 / (k^2 + ||whitened r||^2)."""
    k2 = k * k
    return k2 / (k2 + sq_whitened)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


class _FactorData(NamedTuple):
    i: torch.Tensor  # [F]
    j: torch.Tensor  # [F]
    r: torch.Tensor  # [F, 6]
    Ji: torch.Tensor  # [F, 6, 6]
    Jj: torch.Tensor  # [F, 6, 6]
    W: torch.Tensor  # [F, 6] effective diagonal information (robust-reweighted)
    valid: torch.Tensor  # [F]


def _take(p: Pose, idx) -> Pose:
    return Pose(p.quat[idx], p.trans[idx])


def _linearize(graph: PoseGraph, cfg: PGOConfig, k=None, slots=None):
    """Factor data at the current estimates: the odometry and GPS factors
    of nodes k (default all N) and the loop `slots` (default all L). A slot
    past the capacity (a sharded solve's padding) fails the node or loop
    count test, so it carries no factor."""
    N = graph.gps_z.shape[0]
    L = graph.loop_i.shape[0]
    dev = graph.gps_z.device
    n = graph.n_nodes
    nodes = graph.poses
    k = torch.arange(N, device=dev) if k is None else k
    slots = torch.arange(L, device=dev) if slots is None else slots
    F = k.shape[0]

    ki = torch.clamp(k, max=N - 1)
    kn = torch.clamp(k + 1, max=N - 1)
    odom_valid = (k < n - 1) & ~graph.chain_break[kn]
    r_o, Ji_o, Jj_o = _between_batch(_take(nodes, ki), _take(nodes, kn), _take(graph.odom_rel, ki))
    w_odom = torch.cat([torch.full((3,), 1.0 / cfg.odom_rot_variance, device=dev),
                        torch.full((3,), 1.0 / cfg.odom_trans_variance, device=dev)])
    odom = _FactorData(i=ki, j=kn, r=r_o, Ji=Ji_o, Jj=Jj_o,
                       W=w_odom.expand(F, 6), valid=odom_valid)

    ls = torch.clamp(slots, max=L - 1)
    loop_i, loop_j = graph.loop_i[ls], graph.loop_j[ls]
    loop_valid = slots < graph.n_loops
    r_l, Ji_l, Jj_l = _between_batch(_take(nodes, loop_i), _take(nodes, loop_j),
                                     _take(graph.loop_rel, ls))
    w_loop_base = 1.0 / cfg.loop_variance
    sq_white = torch.sum(r_l * r_l, dim=-1) * w_loop_base
    w_rob = cauchy_weight(sq_white, cfg.cauchy_k)
    loops = _FactorData(i=loop_i, j=loop_j, r=r_l, Ji=Ji_l, Jj=Jj_l,
                        W=w_loop_base * w_rob[:, None] * torch.ones((slots.shape[0], 6), device=dev),
                        valid=loop_valid)

    r_g, J_g = _gps_batch(_take(nodes, ki), graph.gps_z[ki])
    w_g_base = 1.0 / cfg.gps_z_variance
    w_g = w_g_base * cauchy_weight((r_g[:, 0] ** 2) * w_g_base, cfg.cauchy_k)
    J_g6 = torch.cat([J_g, J_g.new_zeros((F, 5, 6))], dim=-2)
    gps = _FactorData(
        i=ki, j=ki, r=torch.cat([r_g, r_g.new_zeros((F, 5))], dim=-1),
        Ji=J_g6, Jj=torch.zeros_like(J_g6),
        W=torch.cat([w_g[:, None], w_g.new_zeros((F, 5))], dim=-1),
        valid=graph.gps_valid[ki] & (k < n),
    )
    return [odom, loops, gps]


def _sanitize(f: _FactorData) -> _FactorData:
    vm = f.valid[:, None]
    return f._replace(
        r=torch.where(vm, f.r, 0.0),
        Ji=torch.where(vm[..., None], f.Ji, 0.0),
        Jj=torch.where(vm[..., None], f.Jj, 0.0),
        W=torch.where(vm, f.W, 0.0),
    )


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """out[k+1] = x[k] (factor k's j-side lands on node k+1)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _JtWr(J, Wr):
    return torch.einsum("frc,fr->fc", J, Wr)


def _JtWJ(Ja, W, Jb):
    return torch.einsum("fri,fr,frj->fij", Ja, W, Jb)


def loop_plans(graph: PoseGraph):
    """The loop factors' rows sorted by their two nodes (segment_sum.plan),
    once an optimise: the loop ends do not change within one. The padding
    slots past n_loops, whose rows are zero, are left out."""
    N = node_capacity(graph)
    valid = torch.arange(loop_capacity(graph), device=graph.loop_i.device) < graph.n_loops
    return tuple(segment_sum.plan(torch.where(valid, ends, N), N)
                 for ends in (graph.loop_i, graph.loop_j))


def _gradient_and_diag(factors, N: int, plans):
    """g = sum A^T W r, the chain-only block diagonal D (odometry + GPS),
    and the loops' block-diagonal part D_loop, per node. The loop rows
    are summed into their nodes in ascending order (`plans`,
    loop_plans), as the reference's `.at[].add` sums them."""
    odom, loops, gps = factors
    plan_i, plan_j = plans
    Wr_o = odom.W * odom.r
    g = _JtWr(odom.Ji, Wr_o) + _shift_down(_JtWr(odom.Jj, Wr_o))
    D = _JtWJ(odom.Ji, odom.W, odom.Ji) + _shift_down(_JtWJ(odom.Jj, odom.W, odom.Jj))
    g = g + _JtWr(gps.Ji, gps.W * gps.r)
    D = D + _JtWJ(gps.Ji, gps.W, gps.Ji)
    Wr_l = loops.W * loops.r
    g = segment_sum.add(g, _JtWr(loops.Ji, Wr_l), plan_i)
    g = segment_sum.add(g, _JtWr(loops.Jj, Wr_l), plan_j)
    D_loop = segment_sum.add(torch.zeros_like(D), _JtWJ(loops.Ji, loops.W, loops.Ji), plan_i)
    D_loop = segment_sum.add(D_loop, _JtWJ(loops.Jj, loops.W, loops.Jj), plan_j)
    return g, D, D_loop


def _hess_matvec(factors, v: torch.Tensor, damping_diag: torch.Tensor, plans,
                 free_mask: torch.Tensor | None = None) -> torch.Tensor:
    """H v without forming H, one launch on the card (ops/kernels/hess_matvec.py:
    the loop rows summed as in _gradient_and_diag); with `free_mask`, the
    CG's where(free, H where(free, v, 0), 0)."""
    odom, loops, gps = factors
    if free_mask is None:
        free_mask = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    return hess_matvec.hess_matvec(odom, gps, loops, plans, v, damping_diag, free_mask)


def _chain_factor(odom, D_blocks, damp, free_mask):
    """Cyclic-reduction factor of the chain operator: the given diagonal
    blocks + damping, the odometry couplings off the diagonal."""
    return _chain_factor_blocks(_JtWJ(odom.Ji, odom.W, odom.Jj), D_blocks, damp, free_mask)


def _chain_factor_blocks(B_chain, D_blocks, damp, free_mask):
    """The chain factor from the coupling blocks B_chain [N, 6, 6] (B[k]
    couples nodes k and k+1); frozen and padding nodes decouple to
    identity."""
    eye6 = torch.eye(6, dtype=D_blocks.dtype, device=D_blocks.device)
    D_chain = D_blocks + damp[:, :, None] * eye6 + 1e-6 * eye6
    D_chain = torch.where(free_mask[:, None, None], D_chain, eye6)
    pair_free = free_mask & torch.roll(free_mask, -1)
    pair_free[-1].fill_(False)
    B_chain = torch.where(pair_free[:, None, None], B_chain, 0.0)
    return blocktri.factor(D_chain, B_chain)


def _chain_precond(chain, free_mask):
    """v -> where(free, C^-1 where(free, v, 0), 0), one launch a call on
    the card (ops/kernels/chain_solve.py)."""
    return lambda v: blocktri.solve(chain, v, free_mask, mask_out=True)


def _masked(hess_mv, free_mask):
    """v -> where(free, hess_mv(where(free, v, 0)), 0)."""
    fm = free_mask[:, None]
    return lambda v: torch.where(fm, hess_mv(torch.where(fm, v, 0.0)), 0.0)


def _run_pcg(mv, g, free_mask, precond, iters: int):
    """Preconditioned CG for H d = -g on the free nodes; mv(v) = H v on the
    free nodes, 0 elsewhere (see _masked)."""
    fm = free_mask[:, None]
    b = torch.where(fm, -g, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = mv(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-20)) * p
        rz = rz_new
    return x


def _damping(D, D_loop, damping: float):
    diag = torch.diagonal(D + D_loop, dim1=-2, dim2=-1)  # [N, 6]
    return damping * torch.clamp(diag, min=1e-6) + 1e-8


def _solve_cg(factors, g, D, D_loop, free_mask, damping: float, iters: int, plans):
    """CG preconditioned by the exact chain Hessian (loops in the matvec only)."""
    damp = _damping(D, D_loop, damping)
    chain = _chain_factor(factors[0], D + D_loop, damp, free_mask)

    return _run_pcg(lambda v: _hess_matvec(factors, v, damp, plans, free_mask), g, free_mask,
                    _chain_precond(chain, free_mask), iters)


def _woodbury_setup(factors, D, D_loop, free_mask, damping: float):
    """The Woodbury preconditioner from one linearization point: the chain
    factor (loop blocks excluded), the V blocks, Z = C^-1 V and S^-1 for
    S = I + V^T Z by 24 Newton-Schulz steps on the Jacobi-scaled S."""
    odom, loops, gps = factors
    N = D.shape[0]
    L = loops.i.shape[0]
    dev = D.device
    damp = _damping(D, D_loop, damping)
    chain = _chain_factor(odom, D, damp, free_mask)

    sw = torch.sqrt(loops.W)  # [L, 6]
    ViT = loops.Ji.mT * sw[:, None, :]
    VjT = loops.Jj.mT * sw[:, None, :]
    ViT = torch.where(free_mask[loops.i][:, None, None], ViT, 0.0)
    VjT = torch.where(free_mask[loops.j][:, None, None], VjT, 0.0)

    lidx = torch.arange(L, device=dev)
    Vd = torch.zeros((N, L, 6, 6), dtype=torch.float32, device=dev)
    Vd[loops.i, lidx] = ViT
    Vd[loops.j, lidx] = VjT
    V6 = Vd.permute(0, 2, 1, 3).reshape(N, 6, 6 * L)
    Z = blocktri.solve(chain, V6)  # C^-1 V, [N, 6, 6L]

    S_lr = (torch.einsum("lnc,lnK->lcK", ViT, Z[loops.i])
            + torch.einsum("lnc,lnK->lcK", VjT, Z[loops.j])).reshape(6 * L, 6 * L)
    eye = torch.eye(6 * L, dtype=torch.float32, device=dev)
    S = 0.5 * (S_lr + S_lr.T) + eye
    sd = torch.sqrt(torch.diagonal(S))
    scale = sd[:, None] * sd[None, :]
    S_scaled = S / scale
    n1 = torch.max(torch.sum(torch.abs(S_scaled), dim=0))
    X = S_scaled.T / torch.clamp(n1 * n1, min=1e-12)
    eye2 = 2.0 * eye
    for _ in range(24):
        X = torch.matmul(X, eye2 - torch.matmul(S_scaled, X))
    Sinv = 0.5 * (X + X.T) / scale
    return chain, ViT, VjT, Sinv, Z


def _wb_precond(wb, loops, free_mask):
    """M^-1 v = C^-1 v - Z S^-1 (V^T C^-1 v): one chain solve per use."""
    chain, ViT, VjT, Sinv, Z = wb
    L = ViT.shape[0]
    fm = free_mask[:, None]

    def precond(v):
        y = blocktri.solve(chain, v, free_mask)
        t = (torch.einsum("lnc,ln->lc", ViT, y[loops.i])
             + torch.einsum("lnc,ln->lc", VjT, y[loops.j])).reshape(6 * L)
        y2 = torch.einsum("ncr,r->nc", Z, torch.matmul(Sinv, t))
        return torch.where(fm, y - y2, 0.0)

    return precond


def _solve_woodbury(factors, g, D, D_loop, free_mask, damping: float, iters: int, plans,
                    wb=None):
    """CG preconditioned by the Woodbury inverse of the full damped Hessian
    H = C + V V^T; `wb` is an optional precomputed _woodbury_setup."""
    damp = _damping(D, D_loop, damping)
    if wb is None:
        wb = _woodbury_setup(factors, D, D_loop, free_mask, damping)
    return _run_pcg(lambda v: _hess_matvec(factors, v, damp, plans, free_mask), g, free_mask,
                    _wb_precond(wb, factors[1], free_mask), iters)


def uses_woodbury(N: int, L: int, cfg: PGOConfig) -> bool:
    """The static solver choice for capacities (N nodes, L loops)."""
    return (cfg.solver == "woodbury" and cfg.wb_min_nodes <= N <= cfg.wb_max_nodes
            and N * 6 * 6 * L * 4 <= cfg.wb_max_z_bytes)


@compiled.jit(static_argnames=("cfg", "cg_iters"))
def optimize(graph: PoseGraph, cfg: PGOConfig, cg_iters: int = 64) -> PoseGraph:
    """Batch damped GN over the whole graph, warm-started from the current
    estimates; node 0 and padding stay fixed. The Woodbury tier uses
    cfg.wb_cg_iters with its preconditioner built once per call; above
    wb_max_nodes chain-CG runs with the large-tier iteration counts."""
    N = graph.gps_z.shape[0]
    L = graph.loop_i.shape[0]
    ks = torch.arange(N, device=graph.gps_z.device)
    free = (ks > 0) & (ks < graph.n_nodes)
    use_wb = uses_woodbury(N, L, cfg)
    gn_iters = cfg.gn_iterations
    if N > cfg.wb_max_nodes:
        cg_iters = min(cg_iters, cfg.cg_iters_large)
        gn_iters = min(gn_iters, cfg.gn_iterations_large)

    plans = loop_plans(graph)
    wb = None
    if use_wb:
        factors0 = [_sanitize(f) for f in _linearize(graph, cfg)]
        _, D0, D_loop0 = _gradient_and_diag(factors0, N, plans)
        wb = _woodbury_setup(factors0, D0, D_loop0, free, cfg.lm_damping)

    for _ in range(gn_iters):
        factors = [_sanitize(f) for f in _linearize(graph, cfg)]
        grad, D, D_loop = _gradient_and_diag(factors, N, plans)
        if use_wb:
            delta = _solve_woodbury(factors, grad, D, D_loop, free, cfg.lm_damping,
                                    cfg.wb_cg_iters, plans, wb=wb)
        else:
            delta = _solve_cg(factors, grad, D, D_loop, free, cfg.lm_damping, cg_iters, plans)
        new = se3.compose(graph.poses, se3.exp_se3(delta))
        graph = graph._replace(poses=Pose(
            torch.where(free[:, None], new.quat, graph.poses.quat),
            torch.where(free[:, None], new.trans, graph.poses.trans),
        ))
    return graph
