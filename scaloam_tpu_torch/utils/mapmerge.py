"""Offline map merger — utils/python/makeMergedMap.py parity (a copy of
scaloam_tpu/utils/mapmerge.py over the port's io modules).

Reference: loads `optimized_poses.txt` (KITTI 3x4 rows) + keyframe
`Scans/*.pcd`, transforms each scan to global, removes near-range points,
stacks with optional downsampling and saves a merged PCD
(makeMergedMap.py:50-57,105-152). Same here, numpy end to end (no open3d
dependency; viewer optional elsewhere).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from scaloam_tpu_torch.io import artifacts, pcd as pcd_io


def merge_map(
    session_dir: str,
    node_skip: int = 1,
    min_range: float = 0.0,
    max_range: Optional[float] = None,
    voxel_size: Optional[float] = None,
    output_path: Optional[str] = None,
) -> np.ndarray:
    """Returns the merged global cloud [N, 3] or [N, 4] (xyz + intensity
    when the saved scans carry it, like the reference's colored merge,
    makeMergedMap.py:100-132); writes a PCD if asked."""
    poses, _, scan_paths, _ = artifacts.load_session(session_dir)
    pieces = []
    for k in range(0, min(len(poses), len(scan_paths)), node_skip):
        raw = pcd_io.read_pcd(scan_paths[k])
        pts = raw[:, :3]
        r = np.linalg.norm(pts, axis=-1)
        keep = r >= min_range
        if max_range is not None:
            keep &= r <= max_range
        pts = pts[keep] @ poses[k][:3, :3].T + poses[k][:3, 3]
        if raw.shape[1] > 3:
            pts = np.concatenate([pts, raw[keep, 3:4]], axis=1)
        pieces.append(pts)
    width = min(p.shape[1] for p in pieces)  # xyz-only if any scan lacks I
    merged = np.concatenate(
        [p[:, :width] for p in pieces], axis=0
    ).astype(np.float32)

    if voxel_size is not None:
        keys = np.floor(merged[:, :3] / voxel_size).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        merged = merged[np.sort(idx)]

    if output_path is not None:
        pcd_io.write_pcd(output_path, merged)
    return merged
