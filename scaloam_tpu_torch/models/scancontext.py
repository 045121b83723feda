"""The ScanContext database (counterpart of scaloam_tpu/models/scancontext.py).

Preallocated descriptor and ring-key tables with a count, grown in
capacity tiers (doubling). The appends write in place (`index_copy_`) into
the tables the database owns; `SCManager` tracks the count on the host, so
appending never reads the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from scaloam_tpu_torch.config import ScanContextConfig
from scaloam_tpu_torch.ops import scancontext as sc_ops


class SCDatabase(NamedTuple):
    descriptors: torch.Tensor  # [K, R, S]
    ring_keys: torch.Tensor  # [K, R]
    count: torch.Tensor  # int64 scalar


def init_db(cfg: ScanContextConfig, device, initial: int = 256) -> SCDatabase:
    K = min(cfg.max_keyframes, initial)
    return SCDatabase(
        descriptors=torch.zeros((K, cfg.num_ring, cfg.num_sector), dtype=torch.float32,
                                device=device),
        ring_keys=torch.zeros((K, cfg.num_ring), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def grow_db(db: SCDatabase, new_capacity: int) -> SCDatabase:
    """The database at a larger capacity, contents kept."""
    K = db.descriptors.shape[0]
    if new_capacity < K:
        raise ValueError(f"grow_db cannot shrink: {K} -> {new_capacity}")
    if new_capacity == K:
        return db

    def pad(a):
        return torch.cat([a, a.new_zeros((new_capacity - K,) + a.shape[1:])])

    return SCDatabase(pad(db.descriptors), pad(db.ring_keys), db.count)


def append_descriptor_(db: SCDatabase, sc: torch.Tensor) -> SCDatabase:
    """Write sc at slot min(count, K-1) in place and advance the count.
    Clamps past capacity: reserve a slot first (grow_db)."""
    i = torch.clamp(db.count, max=db.descriptors.shape[0] - 1).reshape(1)
    db.descriptors.index_copy_(0, i, sc[None])
    db.ring_keys.index_copy_(0, i, sc_ops.ring_key(sc)[None])
    db.count.add_(1)
    return db


def append_descriptor(db: SCDatabase, sc: torch.Tensor, *, count: int | None = None
                      ) -> SCDatabase:
    """Grow the capacity tier on demand, then append. Pass the host-tracked
    `count` to skip reading db.count from the device."""
    n = int(db.count) if count is None else count
    cap = db.descriptors.shape[0]
    if n >= cap:
        db = grow_db(db, max(2 * cap, n + 1))
    return append_descriptor_(db, sc)


def make_and_append(db: SCDatabase, xyz, mask, cfg: ScanContextConfig
                    ) -> Tuple[SCDatabase, torch.Tensor]:
    sc = sc_ops.make_descriptor(
        xyz, mask, num_ring=cfg.num_ring, num_sector=cfg.num_sector,
        max_radius=cfg.max_radius, lidar_height=cfg.lidar_height,
    )
    return append_descriptor_(db, sc), sc


def detect_latest(db: SCDatabase, cfg: ScanContextConfig):
    """Loop detection for the most recent descriptor (indexed on the device
    by count - 1)."""
    query = db.descriptors.index_select(0, (db.count - 1).reshape(1))[0]
    return sc_ops.detect_loop(query, sc_ops.ring_key(query), db.descriptors,
                              db.ring_keys, db.count, cfg, exclude_recent=True)


def detect(db: SCDatabase, query_sc, cfg: ScanContextConfig, exclude_recent: bool = True):
    return sc_ops.detect_loop(query_sc, sc_ops.ring_key(query_sc), db.descriptors,
                              db.ring_keys, db.count, cfg, exclude_recent=exclude_recent)


class SCManager:
    """Stateful wrapper with the reference's API."""

    def __init__(self, cfg: ScanContextConfig, device):
        self.cfg = cfg
        self.db = init_db(cfg, device)
        self._n = 0  # host-tracked count

    def _ensure_slot(self) -> None:
        cap = self.db.descriptors.shape[0]
        if self._n >= cap:
            self.db = grow_db(self.db, 2 * cap)

    def make_and_save(self, xyz, mask) -> torch.Tensor:
        self._ensure_slot()
        self.db, sc = make_and_append(self.db, xyz, mask, self.cfg)
        self._n += 1
        return sc

    def save_descriptor(self, sc: torch.Tensor) -> None:
        self.db = append_descriptor(self.db, sc, count=self._n)
        self._n += 1

    def detect_loop_closure_id(self) -> Tuple[int, float, float]:
        """(loop index or -1, yaw, distance): one device-to-host read."""
        if self._n < self.cfg.num_exclude_recent + 1:
            return -1, 0.0, float("inf")
        idx, yaw, dist = detect_latest(self.db, self.cfg)
        idx, yaw, dist = torch.stack([idx.to(torch.float64), yaw.to(torch.float64),
                                      dist.to(torch.float64)]).tolist()
        return int(idx), yaw, dist

    def detect_between_session(self, query_sc) -> Tuple[int, float, float]:
        idx, yaw, dist = detect(self.db, query_sc, self.cfg, exclude_recent=False)
        idx, yaw, dist = torch.stack([idx.to(torch.float64), yaw.to(torch.float64),
                                      dist.to(torch.float64)]).tolist()
        return int(idx), yaw, dist
