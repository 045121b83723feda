"""Torus-addressed voxel-grid map (counterpart of scaloam_tpu/ops/gridmap.py).

A fixed [G^3, K] cell array addressed modulo the grid: each cell remembers
the absolute cell coordinate it stores, and a cell whose coordinate no
longer matches is stale (lazy eviction on overwrite). Empty slots sit at a
far sentinel so the k-NN gather needs no validity masks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from reference.slam.ops import f32, voxel as _voxel
from reference.slam.ops.kernels import f32ops

_FAR = 1e9  # sentinel position for empty point slots (see knn_grid)
_NO_CELL = 2**30  # cell coordinate of a never-written cell


class GridMap(NamedTuple):
    pts: torch.Tensor  # [C, K, 3] f32
    count: torch.Tensor  # [C] int32 valid entries
    cell_coord: torch.Tensor  # [C, 3] int32 absolute cell coords stored
    total: torch.Tensor  # int32 scalar: total valid points


def _flat_idx(cc: torch.Tensor, gx: int, gy: int, gz: int) -> torch.Tensor:
    """Absolute cell coords [.., 3] -> torus flat index (floor modulo)."""
    return (
        (cc[..., 0] % gx) * (gy * gz)
        + (cc[..., 1] % gy) * gz
        + (cc[..., 2] % gz)
    )


def insert(grid: GridMap, xyz: torch.Tensor, mask: torch.Tensor,
           gx: int, gy: int, gz: int, cell_size: float,
           dedup_radius: float) -> GridMap:
    """Insert points [N, 3] (masked). A point is skipped when its cell
    already holds a point within dedup_radius; points of different absolute
    cells aliasing one torus slot in a batch keep only the lowest packed
    coordinate; stale cells are reset to the far sentinel before writing."""
    N = xyz.shape[0]
    C, K = grid.pts.shape[0], grid.pts.shape[1]
    dev = xyz.device
    cc = f32.cell_of(xyz, cell_size)
    idx = _flat_idx(cc, gx, gy, gz).to(torch.int64)
    idx = torch.where(mask, idx, C)  # invalid -> dump slot
    idx_c = torch.clamp(idx, max=C - 1)

    stored_cc = grid.cell_coord[idx_c]
    fresh = torch.all(stored_cc == cc, dim=-1)
    base = torch.where(fresh, grid.count[idx_c], 0)

    # Occupancy dedup vs existing cell content (only when fresh).
    cell_pts = grid.pts[idx_c]  # [N, K, 3]
    d2 = candidate_sq_dist(cell_pts, xyz)
    occ = torch.arange(K, device=dev)[None, :] < base[:, None]
    near = torch.any(occ & (d2 < dedup_radius * dedup_radius), dim=-1) & fresh
    want = mask & ~near

    # Batch-internal torus-aliasing guard: lowest packed coord wins a slot.
    pack = ((cc[:, 0] & 0x3FF) << 20) | ((cc[:, 1] & 0x3FF) << 10) | (cc[:, 2] & 0x3FF)
    win_pack = torch.full((C + 1,), _NO_CELL, dtype=torch.int32, device=dev)
    win_pack = win_pack.scatter_reduce(
        0, idx, torch.where(mask, pack, _NO_CELL).to(torch.int32), "amin"
    )[:-1]
    win = mask & (pack == win_pack[idx_c])
    want = want & win

    # Rank of each inserted point within its cell (batch-local, stable).
    order = torch.argsort(torch.where(want, idx, _NO_CELL), stable=True)
    idx_s = idx[order]
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), idx_s[1:] != idx_s[:-1]])
    iota = torch.arange(N, device=dev)
    seg_start = torch.cummax(torch.where(newseg, iota, 0), dim=0).values
    rank = torch.zeros(N, dtype=torch.int64, device=dev).scatter(0, order, iota - seg_start)

    pos = base + rank
    ok = want & (pos < K)
    write_idx = torch.where(ok, idx, C)

    touched_add = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    touched_add = touched_add.index_add(0, write_idx, ok.to(torch.int32))[:-1]
    reset = torch.zeros(C + 1, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(win, idx, C), (win & ~fresh).to(torch.int32), "amax"
    )[:-1]

    # Reset cells are cleared to the far sentinel BEFORE the new points land
    # (knn_grid has no validity masks). Rows with ok == False write into an
    # extra dump cell that is cut off afterwards.
    pts = torch.where((reset > 0)[:, None, None], _FAR, grid.pts)
    pts = torch.cat([pts, pts.new_full((1, K, 3), _FAR)])
    pts[write_idx, torch.where(ok, pos, 0)] = xyz
    pts = pts[:C]
    new_count = torch.clamp(
        torch.where(reset > 0, touched_add, grid.count + touched_add), max=K
    ).to(torch.int32)
    coord_new = torch.cat([grid.cell_coord, grid.cell_coord.new_zeros((1, 3))])
    coord_new[write_idx] = cc
    touched = (reset > 0) | (touched_add > 0)
    cell_coord = torch.where(touched[:, None], coord_new[:C], grid.cell_coord)
    total = torch.sum(new_count).to(torch.int32)
    return GridMap(pts=pts, count=new_count, cell_coord=cell_coord, total=total)


def _combos(base: int, device) -> torch.Tensor:
    """[[a, b, c] for a in range(base) for b in range(base) for c in
    range(base)] as int32 [base^3, 3], made on the device."""
    k = torch.arange(base ** 3, dtype=torch.int32, device=device)
    return torch.stack([k // (base * base), (k // base) % base, k % base], dim=-1)


def candidate_cells8(lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8 candidate cells per query (each axis picks lo or hi) plus the
    canonical-combo mask: where lo == hi on an axis only the all-lo combo
    survives, so no map point fills two candidate slots.
    Returns (cc8 [Q, 8, 3], uniq [Q, 8] bool)."""
    combos = _combos(2, lo.device)
    cc8 = torch.where(combos[None] > 0, hi[:, None, :], lo[:, None, :])
    uniq = torch.all((combos[None] == 0) | (hi != lo)[:, None, :], dim=-1)
    return cc8, uniq


def candidate_bounds(query: torch.Tensor, cell_size: float, reach: float):
    """Per query [Q, 3], the lowest and highest cell its reach touches on
    each axis: (lo [Q, 3], hi [Q, 3]) int32."""
    return f32.cell_of(query - reach, cell_size), f32.cell_of(query + reach, cell_size)


def candidate_sq_dist(cand: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Squared distances of candidate points [Q, ..., 3] to their query
    [Q, 3], rounded as the reference ranks them (a chain of fused
    multiply-adds): [Q, ...]."""
    return f32ops.sum3_sq(cand - query.reshape(query.shape[0], *[1] * (cand.dim() - 2), 3))


def knn_grid(grid: GridMap, query: torch.Tensor, query_mask: torch.Tensor,
             gx: int, gy: int, gz: int, cell_size: float, reach: float, k: int):
    """Exact k-NN among map points within `reach` of each query over the
    2x2x2 (2*reach <= cell_size) or 3x3x3 candidate cells.
    Returns (d2 [Q, k] ascending, BIG for masked queries; xyz [Q, k, 3])."""
    if reach > cell_size:
        raise ValueError("coverage needs 2*reach <= 2*cell_size")
    if reach > min(gx, gy, gz) * cell_size / 4:
        raise ValueError("reach too close to the torus period")
    Q = query.shape[0]
    lo, hi = candidate_bounds(query, cell_size, reach)
    if 2 * reach <= cell_size:
        cc8, uniq = candidate_cells8(lo, hi)
    else:
        combos = _combos(3, query.device)
        cc8 = lo[:, None, :] + combos[None]
        uniq = None
    idx8 = _flat_idx(cc8, gx, gy, gz).to(torch.int64)  # [Q, 8]
    cand = grid.pts[idx8]  # [Q, 8, K, 3]
    d2 = candidate_sq_dist(cand, query)
    if uniq is not None:
        d2 = torch.where(uniq[:, :, None], d2, _voxel.BIG)
    d_k, nn = _voxel.argmin_topk(d2.reshape(Q, -1), k, cand.reshape(Q, -1, 3))
    d_out = torch.where(query_mask[:, None], d_k, _voxel.BIG)
    return d_out, nn


