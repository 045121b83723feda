"""Sharded ScanContext retrieval: the descriptor database's rows split over
the `kf` axis (counterpart of scaloam_tpu/parallel/sc_retrieval.py).

Each rank runs the exact ring-key k-NN and the shifted distance over its
own rows, then the ranks' winners, a (distance, global index, shift)
triple each, are combined by one all_gather and an argmin that sends ties
to the lowest rank, as jnp.argmin does. A shard's top-k is a superset of
the single-device global top-k, so retrieval is never worse than
ops/scancontext.detect_loop's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from scaloam_tpu_torch.config import ScanContextConfig
from scaloam_tpu_torch.ops import scancontext as sc_ops
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel.mesh import KF_AXIS


def detect_loop_sharded(mesh, query_sc: torch.Tensor, db_sc: torch.Tensor,
                        db_keys: torch.Tensor, db_count: torch.Tensor,
                        cfg: ScanContextConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """query_sc [R, S] (replicated); db_sc [K', R, S] and db_keys [K', R]:
    this rank's rows of the database (mesh.shard_rows; padding rows lie
    past db_count and are never valid); db_count the replicated count.
    Returns (loop_idx int64, -1 if none; yaw; min distance) like
    ops.scancontext.detect_loop, the same on every rank."""
    rows = db_sc.shape[0]
    base = mesh_mod.axis_index(mesh, KF_AXIS) * rows
    limit = db_count - cfg.num_exclude_recent
    valid = base + torch.arange(rows, device=db_sc.device) < limit
    _, cand = sc_ops.ring_key_knn(sc_ops.ring_key(query_sc), db_keys, valid, cfg.num_candidates)
    dists, shifts = sc_ops.sc_distance(query_sc, db_sc[cand], cfg.search_ratio)
    dists = torch.where(base + cand < limit, dists, sc_ops.BIG)
    j = torch.argmin(dists).reshape(1)
    local_best = torch.cat([dists.index_select(0, j),
                            (base + cand.index_select(0, j)).to(torch.float32),
                            shifts.index_select(0, j).to(torch.float32)])
    every = mesh_mod.all_gather(local_best, mesh, KF_AXIS)  # [n, 3]
    w = torch.argmin(every[:, 0]).reshape(1)
    min_dist, nn_idx, shift = every.index_select(0, w)[0].unbind()
    loop_idx = torch.where(min_dist < cfg.dist_threshold, nn_idx.to(torch.int64), -1)
    yaw = shift * (2.0 * math.pi / cfg.num_sector)
    return loop_idx, yaw, min_dist
