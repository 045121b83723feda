"""Ring-constrained companion search for scan-to-scan odometry
(counterpart of scaloam_tpu/ops/correspond.py).

For each query, with the ring of its 1-NN known, find the nearest targets
on the SAME ring (excluding the 1-NN itself) and on a DIFFERENT ring within
+-`nearby` rings, over target tiles so only one [Q, tile] distance block
lives at a time. Candidates rank by |q|^2 + |t|^2 - 2 q.t like the
reference's, and ties go to the lowest target index. The odometry calls
`ring_constrained_nn2_pts` (winner points); `ring_constrained_nn` and
`ring_constrained_nn2` return target indices.
"""

from __future__ import annotations

import torch

from scaloam_tpu_torch.ops import voxel
from scaloam_tpu_torch.ops.kernels import f32ops


def _ring_masks(query, ring_ref, exclude_idx, target_ring, nearby: float, t0: int, n: int):
    """(same, other) masks [Q, n] of target tile [t0, t0 + n)."""
    adr = torch.abs(target_ring[None, t0 : t0 + n] - ring_ref[:, None])
    gidx = t0 + torch.arange(n, device=query.device)[None, :]
    return (adr < 0.5) & (gidx != exclude_idx[:, None]), (adr >= 0.5) & (adr <= nearby)


def ring_constrained_nn(query, query_mask, ring_ref, exclude_idx, target, target_mask,
                        target_ring, nearby: float, tile: int = 2048):
    """Returns (d_same [Q], i_same [Q], d_other [Q], i_other [Q]): squared
    distances (BIG when none, clamped at 0) and indices (0 when none)."""
    tile = voxel.fit_tile(target.shape[0], tile)
    Q = query.shape[0]
    dev = query.device
    best = [torch.full((Q,), voxel.BIG, dtype=torch.float32, device=dev),
            torch.zeros((Q,), dtype=torch.int64, device=dev)] * 2
    for t0 in range(0, target.shape[0], tile):
        tgt = target[t0 : t0 + tile]
        d = f32ops.sq_dist(query, tgt)
        base = target_mask[None, t0 : t0 + tile]
        for k, cls in enumerate(_ring_masks(query, ring_ref, exclude_idx, target_ring,
                                            nearby, t0, tgt.shape[0])):
            v, j = torch.min(torch.where(base & cls, d, voxel.BIG), dim=1)
            upd = v < best[2 * k]  # strict: an equal later tile keeps the lower index
            best[2 * k] = torch.where(upd, v, best[2 * k])
            best[2 * k + 1] = torch.where(upd, t0 + j, best[2 * k + 1])
    ds, is_, do, io = best
    clamp = lambda x: torch.where(query_mask, torch.clamp(x, min=0.0), voxel.BIG)
    return clamp(ds), is_, clamp(do), io


def ring_constrained_nn2(query, query_mask, ring_ref, exclude_idx, target, target_mask,
                         target_ring, nearby: float, tile: int = 4096):
    """Top-2 variant: (d_same [Q, 2], i_same [Q, 2], d_other [Q, 2],
    i_other [Q, 2]) ascending; a slot no target fills keeps index 0."""
    tile = voxel.fit_tile(target.shape[0], tile)
    Q = query.shape[0]
    dev = query.device
    d0 = torch.full((Q,), voxel.BIG, dtype=torch.float32, device=dev)
    i0 = torch.zeros((Q,), dtype=torch.int64, device=dev)
    best = [(d0, i0, d0, i0)] * 2
    for t0 in range(0, target.shape[0], tile):
        tgt = target[t0 : t0 + tile]
        d = f32ops.sq_dist(query, tgt)
        base = target_mask[None, t0 : t0 + tile]
        for k, cls in enumerate(_ring_masks(query, ring_ref, exclude_idx, target_ring,
                                            nearby, t0, tgt.shape[0])):
            best[k] = voxel.merge_top2(
                best[k], voxel.tile_top2(torch.where(base & cls, d, voxel.BIG), t0))
    out = []
    for b1d, b1i, b2d, b2i in best:
        dd = torch.stack([b1d, b2d], dim=1)
        out += [torch.where(query_mask[:, None], torch.clamp(dd, min=0.0), voxel.BIG),
                torch.stack([b1i, b2i], dim=1)]
    return tuple(out)


def ring_constrained_nn2_pts(
    query: torch.Tensor,  # [Q, 3]
    query_mask: torch.Tensor,  # [Q]
    ring_ref: torch.Tensor,  # [Q] ring of the 1-NN (float)
    exclude_idx: torch.Tensor,  # [Q] index of the 1-NN
    target: torch.Tensor,  # [T, 3]
    target_mask: torch.Tensor,  # [T]
    target_ring: torch.Tensor,  # [T] float
    nearby: float,
    tile: int = 4096,
    want_same: bool = True,
):
    """Returns (d_same [Q, 2], p_same [Q, 2, 3], d_other [Q, 2],
    p_other [Q, 2, 3]): ascending squared distances (BIG when none) and
    the winner points. want_same=False (the corner pass) skips the
    same-ring search: its distances are then BIG and its points zero."""
    tile = voxel.fit_tile(target.shape[0], tile)
    Q = query.shape[0]
    dev = query.device
    best_s = voxel.empty_top2(Q, dev)
    best_o = voxel.empty_top2(Q, dev)
    for t0 in range(0, target.shape[0], tile):
        tgt = target[t0 : t0 + tile]
        base = target_mask[None, t0 : t0 + tile]
        d = f32ops.sq_dist(query, tgt)
        adr = torch.abs(target_ring[None, t0 : t0 + tile] - ring_ref[:, None])
        other = (adr >= 0.5) & (adr <= nearby)
        if want_same:
            gidx = t0 + torch.arange(tgt.shape[0], device=dev)[None, :]
            same = (adr < 0.5) & (gidx != exclude_idx[:, None])
            d_s = torch.where(base & same, d, voxel.BIG)
            best_s = voxel.merge_top2(best_s, voxel.tile_top2(d_s, t0))
        d_o = torch.where(base & other, d, voxel.BIG)
        best_o = voxel.merge_top2(best_o, voxel.tile_top2(d_o, t0))

    def finish(best):
        b1d, b1i, b2d, b2i = best
        dd = torch.stack([b1d, b2d], dim=1)
        dd = torch.where(query_mask[:, None], torch.clamp(dd, min=0.0), voxel.BIG)
        return dd, voxel.gather_rows(target, torch.stack([b1i, b2i], dim=1))

    return finish(best_s) + finish(best_o)
