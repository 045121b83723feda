"""Sharded torus voxel-grid map: the cells split over the `kf` axis
(counterpart of scaloam_tpu/parallel/gridmap.py).

Each rank owns a contiguous slab of torus cells. Queries are replicated;
every rank answers the 2x2x2 neighbour gather for the cells it owns, and
the ranks' k-NN candidates are merged by one all_gather of [Q, k]
distances and [Q, k, 3] points. Both top-k's are ops/voxel.argmin_topk,
whose ties go to the lowest index as lax.top_k's do, so the result equals
ops/gridmap.knn_grid's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scaloam_tpu_torch.ops import gridmap as gm
from scaloam_tpu_torch.ops import voxel
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel.mesh import KF_AXIS


def shard_grid(mesh, grid: gm.GridMap) -> gm.GridMap:
    """This rank's slab of a replicated grid; padding cells hold the far
    sentinel and are never addressed (every flat index is below C)."""
    return gm.GridMap(
        pts=mesh_mod.shard_rows(mesh, grid.pts, fill=gm._FAR),
        count=mesh_mod.shard_rows(mesh, grid.count),
        cell_coord=mesh_mod.shard_rows(mesh, grid.cell_coord, fill=gm._NO_CELL),
        total=grid.total,
    )


def knn_grid_sharded(mesh, grid: gm.GridMap, query: torch.Tensor, query_mask: torch.Tensor,
                     gx: int, gy: int, gz: int, cell_size: float, reach: float,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded ops.gridmap.knn_grid over the 2x2x2 candidate cells. grid is
    this rank's slab (shard_grid); query [Q, 3] and query_mask [Q] are
    replicated. Returns (d2 [Q, k] ascending, BIG for masked queries; xyz
    [Q, k, 3]), the same on every rank."""
    if 2 * reach > cell_size:
        raise ValueError("knn_grid_sharded gathers 2x2x2 cells: needs 2*reach <= cell_size")
    n_cells, n_shards = gx * gy * gz, mesh_mod.axis_size(mesh, KF_AXIS)
    slab = grid.pts.shape[0]
    if slab != mesh_mod.pad_to_shards(n_cells, n_shards) // n_shards:
        raise ValueError(f"a slab of {slab} cells does not shard {n_cells} cells "
                         f"over {n_shards} ranks")
    base = mesh_mod.axis_index(mesh, KF_AXIS) * slab
    Q = query.shape[0]
    lo, hi = gm.candidate_bounds(query, cell_size, reach)
    # The single-device knn_grid's combos and canonical-combo mask, so a
    # collapsed axis cannot fill two candidate slots with one point here
    # either; then only the cells this rank owns.
    cc8, uniq = gm.candidate_cells8(lo, hi)
    idx8 = gm._flat_idx(cc8, gx, gy, gz).to(torch.int64)  # [Q, 8] global cell ids
    mine = (idx8 >= base) & (idx8 < base + slab) & uniq
    # Empty slots hold the far sentinel, so the ownership mask is the only
    # one needed: a clipped index of a cell owned elsewhere would alias
    # another cell's real points.
    cand = grid.pts[torch.clamp(idx8 - base, 0, slab - 1)]  # [Q, 8, K, 3]
    d2 = torch.where(mine[:, :, None], gm.candidate_sq_dist(cand, query), voxel.BIG)
    d_local, nn_local = voxel.argmin_topk(d2.reshape(Q, -1), k, cand.reshape(Q, -1, 3))
    all_d = mesh_mod.all_gather(d_local, mesh, KF_AXIS).movedim(0, 1).reshape(Q, -1)
    all_nn = mesh_mod.all_gather(nn_local, mesh, KF_AXIS).movedim(0, 1).reshape(Q, -1, 3)
    d_k, nn = voxel.argmin_topk(all_d, k, all_nn)
    return torch.where(query_mask[:, None], d_k, voxel.BIG), nn
