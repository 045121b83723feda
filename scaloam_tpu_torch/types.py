"""Core tensor tuples (counterparts of scaloam_tpu/types.py).

A scan is a padded fixed-capacity tensor plus a validity mask; a pose is a
(quat wxyz, translation) pair. Every constructor takes its device
explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scaloam_tpu_torch import device as _device


class Pose(NamedTuple):
    """SE(3) pose: unit quaternion (w, x, y, z) + translation (x, y, z)."""

    quat: torch.Tensor  # [..., 4] wxyz
    trans: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(device, batch_shape=()) -> "Pose":
        """Identity poses of shape `batch_shape` (a fresh tensor each)."""
        batch_shape = tuple(batch_shape)
        q = torch.zeros(batch_shape + (4,), dtype=torch.float32, device=device)
        q[..., 0] = 1.0
        return Pose(q, torch.zeros(batch_shape + (3,), dtype=torch.float32, device=device))


class LidarScan(NamedTuple):
    """One padded raw scan: xyz [N, 3] f32 (padding rows zero), mask [N] bool."""

    xyz: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @staticmethod
    def from_numpy(points: np.ndarray, capacity: int, device=None) -> "LidarScan":
        """Pad/truncate an [n, 3+] float array into a fixed-capacity scan
        on `device` (default `cuda`)."""
        dev = _device.resolve(device)
        n = min(points.shape[0], capacity)
        xyz = np.zeros((capacity, 3), dtype=np.float32)
        xyz[:n] = points[:n, :3]
        mask = np.zeros((capacity,), dtype=bool)
        mask[:n] = True
        return LidarScan(torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev))


class RangeImage(NamedTuple):
    """Ring-structured scan [n_scans, width]: xyz [S, W, 3], mask [S, W],
    rel_time [S, W] in [0, 1), count [S] int32 valid points per ring."""

    xyz: torch.Tensor
    mask: torch.Tensor
    rel_time: torch.Tensor
    count: torch.Tensor


class FeatureCloud(NamedTuple):
    """One padded feature set with per-point ring id + relative time."""

    xyz: torch.Tensor  # [M, 3]
    ring: torch.Tensor  # [M] float32 (ring id; padding = -1)
    rel_time: torch.Tensor  # [M] float32
    mask: torch.Tensor  # [M] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @staticmethod
    def empty(capacity: int, device) -> "FeatureCloud":
        return FeatureCloud(
            xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            ring=-torch.ones((capacity,), dtype=torch.float32, device=device),
            rel_time=torch.zeros((capacity,), dtype=torch.float32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class ScanFeatures(NamedTuple):
    """Output of feature extraction: the five published clouds plus the
    count of valid feature rows lost to capacity truncation (int32 scalar)."""

    sharp: FeatureCloud
    less_sharp: FeatureCloud
    flat: FeatureCloud
    less_flat: FeatureCloud
    full: RangeImage
    overflow: torch.Tensor
