"""Distributed pose-graph Gauss-Newton: the factors split over the `kf`
axis (counterpart of scaloam_tpu/parallel/pgo.py).

The poses are replicated (6N floats). Each rank linearises its slice of
the odometry and GPS factors (nodes [r * shard, (r + 1) * shard)) and of
the loop factors, scatter-adds the gradient, the diagonal blocks and the
chain coupling blocks by node (each node's rows in ascending order,
ops/kernels/segment_sum.py), and one all_reduce per GN iteration sums
them; the CG matvec is scattered the same way and all_reduced once per CG
iteration. The cyclic-reduction chain preconditioner is then factored and
applied replicated, on every rank alike. Capacities that the mesh does
not divide are padded: padding slots fail the node and loop count tests
and carry no factor. The einsums run in full f32 (the package switches
TF32 off), as the reference's Precision.HIGHEST asks.

A drop-in for models.posegraph.optimize's chain-CG step with
`cfg.gn_iterations` GN iterations of `cg_iters` CG iterations each, as the
reference has it; the Woodbury tier and the large-tier iteration caps of
the single-device policy are not applied here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from scaloam_tpu_torch.config import PGOConfig
from scaloam_tpu_torch.models import posegraph as pg
from scaloam_tpu_torch.ops import se3
from scaloam_tpu_torch.ops.kernels import segment_sum
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel.mesh import KF_AXIS
from scaloam_tpu_torch.types import Pose


def _plans(factors, N: int):
    """Each factor kind's rows sorted by their i and j nodes
    (segment_sum.plan), once an optimise; the invalid rows (zero) left out."""
    return [tuple(segment_sum.plan(torch.where(f.valid, ends, N), N) for ends in (f.i, f.j))
            for f in factors]


def _scatter_blocks(factors, N: int, plans):
    """This rank's gradient [N, 6], diagonal blocks [N, 6, 6] (all factor
    kinds) and odometry coupling blocks B [N, 6, 6], scattered by node,
    each node's rows added in ascending order."""
    dev = factors[0].r.device
    g = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    D = torch.zeros((N, 6, 6), dtype=torch.float32, device=dev)
    for f, (pi, pj) in zip(factors, plans):
        Wr = f.W * f.r
        g = segment_sum.add(g, pg._JtWr(f.Ji, Wr), pi)
        g = segment_sum.add(g, pg._JtWr(f.Jj, Wr), pj)
        D = segment_sum.add(D, pg._JtWJ(f.Ji, f.W, f.Ji), pi)
        D = segment_sum.add(D, pg._JtWJ(f.Jj, f.W, f.Jj), pj)
    odom = factors[0]
    B = segment_sum.add(torch.zeros_like(D), pg._JtWJ(odom.Ji, odom.W, odom.Jj), plans[0][0])
    return g, D, B


def _matvec(factors, v, damp, group, plans):
    """H v summed over the ranks: the damping is taken out before the
    all_reduce and added back after it, so it counts once."""
    out = damp * v
    for f, (pi, pj) in zip(factors, plans):
        Av = torch.einsum("frc,fc->fr", f.Ji, v[f.i]) + torch.einsum("frc,fc->fr", f.Jj, v[f.j])
        WAv = f.W * Av
        out = segment_sum.add(out, pg._JtWr(f.Ji, WAv), pi)
        out = segment_sum.add(out, pg._JtWr(f.Jj, WAv), pj)
    out = out - damp * v
    dist.all_reduce(out, group=group)
    return out + damp * v


def optimize_sharded(graph: pg.PoseGraph, cfg: PGOConfig, mesh,
                     cg_iters: int = 64) -> pg.PoseGraph:
    """models.posegraph.optimize on a mesh: graph is replicated on every
    rank of the `kf` axis and so is the result."""
    N, L = pg.node_capacity(graph), pg.loop_capacity(graph)
    n_shards = mesh_mod.axis_size(mesh, KF_AXIS)
    me = mesh_mod.axis_index(mesh, KF_AXIS)
    group = mesh_mod.axis_group(mesh, KF_AXIS)
    dev = graph.gps_z.device
    sn = mesh_mod.pad_to_shards(N, n_shards) // n_shards
    sl = mesh_mod.pad_to_shards(L, n_shards) // n_shards
    k = me * sn + torch.arange(sn, device=dev)  # this rank's odometry / GPS factors
    slots = me * sl + torch.arange(sl, device=dev)  # and loop slots
    ks = torch.arange(N, device=dev)
    free = (ks > 0) & (ks < graph.n_nodes)
    fm = free[:, None]
    plans = None
    for _ in range(cfg.gn_iterations):
        factors = [pg._sanitize(f) for f in pg._linearize(graph, cfg, k, slots)]
        if plans is None:  # the factors' nodes stay the same from here on
            plans = _plans(factors, N)
        g, D, B = _scatter_blocks(factors, N, plans)
        summed = torch.cat([g.reshape(-1), D.reshape(-1), B.reshape(-1)])
        dist.all_reduce(summed, group=group)
        g, D, B = summed.split([N * 6, N * 36, N * 36])
        g, D, B = g.reshape(N, 6), D.reshape(N, 6, 6), B.reshape(N, 6, 6)
        damp = pg._damping(D, 0.0, cfg.lm_damping)
        chain = pg._chain_factor_blocks(B, D, damp, free)
        delta = pg._run_pcg(pg._masked(lambda v: _matvec(factors, v, damp, group, plans), free),
                            g, free, pg._chain_precond(chain, free), cg_iters)
        new = se3.compose(graph.poses, se3.exp_se3(delta))
        graph = graph._replace(poses=Pose(torch.where(fm, new.quat, graph.poses.quat),
                                          torch.where(fm, new.trans, graph.poses.trans)))
    return graph
