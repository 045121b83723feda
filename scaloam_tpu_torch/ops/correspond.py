"""Ring-constrained companion search for scan-to-scan odometry
(counterpart of scaloam_tpu/ops/correspond.py:ring_constrained_nn2_pts).

For each query, with the ring of its 1-NN known, find the two nearest
targets on the SAME ring (excluding the 1-NN itself) and the two nearest on
a DIFFERENT ring within +-`nearby` rings, over target tiles so only one
[Q, tile] distance block lives at a time.
"""

from __future__ import annotations

import torch

from scaloam_tpu_torch.ops import voxel


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
        d = voxel.sq_dist(query, tgt)
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
