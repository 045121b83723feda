"""ScanContext descriptor and retrieval (counterpart of
scaloam_tpu/ops/scancontext.py).

Descriptor: a 20-ring x 60-sector polar grid over 80 m holding each bin's
max z (+2 m sensor height). Ring key = row means, sector key = column
means. Distance: cosine distance averaged over columns non-empty in both,
at the best circular shift inside a window around the sector-key
alignment. Retrieval: exact ring-key k-NN over the live database, then the
distance of each candidate.

The reference's two-key sort (a TPU stand-in for a serial scatter-max)
becomes one `scatter_reduce("amax")` into a zero grid: untouched bins stay
0 and a bin whose max z is negative stays negative, as there.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from scaloam_tpu_torch.config import ScanContextConfig

BIG = 1e10


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, num_ring: int = 20,
                    num_sector: int = 60, max_radius: float = 80.0,
                    lidar_height: float = 2.0) -> torch.Tensor:
    """Polar max-z grid [num_ring, num_sector]."""
    x, y = xyz[:, 0], xyz[:, 1]
    z = xyz[:, 2] + lidar_height
    r = torch.sqrt(x * x + y * y)
    theta = torch.remainder(torch.rad2deg(torch.atan2(y, x)), 360.0)
    ring = torch.clamp(torch.ceil(r / max_radius * num_ring), 1, num_ring) - 1
    sector = torch.clamp(torch.ceil(theta / 360.0 * num_sector), 1, num_sector) - 1
    ok = mask & (r <= max_radius)
    n_bins = num_ring * num_sector
    bins = torch.where(ok, (ring * num_sector + sector).to(torch.int64), n_bins)
    grid = torch.zeros(n_bins + 1, dtype=torch.float32, device=xyz.device)
    grid = grid.scatter_reduce(0, bins, z, "amax", include_self=False)
    return grid[:n_bins].reshape(num_ring, num_sector)


def ring_key(sc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant key: row means. [..., R, S] -> [..., R]."""
    return torch.mean(sc, dim=-1)


def sector_key(sc: torch.Tensor) -> torch.Tensor:
    """Column means. [..., R, S] -> [..., S]."""
    return torch.mean(sc, dim=-2)


def _all_shifts(sc: torch.Tensor) -> torch.Tensor:
    """[..., R, S] -> [..., S, R, S] where out[s] = circshift(sc, s)
    (columns moved right by s)."""
    S = sc.shape[-1]
    cols = torch.arange(S, device=sc.device)
    src = torch.remainder(cols[None, :] - cols[:, None], S)  # [shift, col]
    return sc[..., :, src].movedim(-2, -3)


def sc_distance(sc1: torch.Tensor, sc2: torch.Tensor, search_ratio: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min cosine distance, argmin shift) over the shift window seeded by
    the sector-key alignment. sc2 may carry leading batch dims [..., R, S]."""
    S = sc1.shape[-1]
    shifted = _all_shifts(sc2)  # [..., S, R, S]
    vk1 = sector_key(sc1)
    vkey_diff = torch.sum((vk1 - sector_key(shifted)) ** 2, dim=-1)  # [..., S]
    align = torch.argmin(vkey_diff, dim=-1, keepdim=True)

    n1 = torch.linalg.vector_norm(sc1, dim=-2)  # [S] column norms
    n2 = torch.linalg.vector_norm(shifted, dim=-2)  # [..., S, S]
    dots = torch.sum(sc1 * shifted, dim=-2)
    eff = (n1 > 0) & (n2 > 0)
    cossim = torch.where(eff, dots / torch.clamp(n1 * n2, min=1e-20), 0.0)
    n_eff = torch.sum(eff, dim=-1)
    dist = 1.0 - torch.sum(cossim, dim=-1) / torch.clamp(n_eff, min=1)
    dist = torch.where(n_eff > 0, dist, BIG)

    radius = round(0.5 * search_ratio * S)
    offs = torch.arange(S, device=sc1.device)
    circ = torch.minimum(torch.remainder(offs - align, S), torch.remainder(align - offs, S))
    dist_w = torch.where(circ <= radius, dist, BIG)
    best = torch.argmin(dist_w, dim=-1, keepdim=True)
    return torch.gather(dist_w, -1, best)[..., 0], best[..., 0]


def ring_key_knn(query_key, db_keys, db_valid, num_candidates: int):
    """Exact ring-key k-NN by brute-force L2: the first `num_candidates` of
    a stable ascending sort, so equal distances keep the lower index."""
    d = torch.sum((db_keys - query_key[None, :]) ** 2, dim=-1)
    d = torch.where(db_valid, d, BIG)
    vals, idx = torch.sort(d, stable=True)
    return vals[:num_candidates], idx[:num_candidates]


def detect_loop(query_sc, query_key, db_sc, db_keys, db_count,
                cfg: ScanContextConfig, exclude_recent: bool = True):
    """Full retrieval. db_count is a scalar tensor. Returns (loop_idx int64,
    -1 if none; yaw in radians; min distance), all device scalars."""
    K = db_sc.shape[0]
    limit = db_count - (cfg.num_exclude_recent if exclude_recent else 0)
    valid = torch.arange(K, device=db_sc.device) < limit
    _, cand = ring_key_knn(query_key, db_keys, valid, cfg.num_candidates)
    dists, shifts = sc_distance(query_sc, db_sc[cand], cfg.search_ratio)
    dists = torch.where(cand < limit, dists, BIG)
    j = torch.argmin(dists).reshape(1)  # gathers below, no read of j
    min_dist = dists.index_select(0, j)[0]
    found = min_dist < cfg.dist_threshold
    loop_idx = torch.where(found, cand.index_select(0, j)[0], -1)
    yaw = shifts.index_select(0, j)[0].to(torch.float32) * (2.0 * math.pi / cfg.num_sector)
    return loop_idx, yaw, min_dist
