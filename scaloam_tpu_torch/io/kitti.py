"""KITTI odometry dataset reader — the kittiHelper equivalent.

Reference: src/kittiHelper.cpp — reads `times.txt`, ground-truth poses and
velodyne `.bin` files (float32 x,y,z,intensity quads, :25-35,130-151) and
republishes at 10 Hz with the camera->velodyne axis remap
R = [[0,0,1],[-1,0,0],[0,-1,0]] (:78-80,108-111). Here: an iterator of
numpy scans + poses feeding the host pipeline directly.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

# cam -> velo remap used for ground-truth poses (kittiHelper.cpp:78-80)
R_CAM_TO_VELO = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
)


def read_velodyne_bin(path: str) -> np.ndarray:
    """[N, 4] float32 (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_times(sequence_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(sequence_dir, "times.txt"))


def read_poses(pose_file: str, remap_to_velo: bool = True) -> np.ndarray:
    """KITTI ground-truth poses [N, 4, 4] (camera frame; optionally remapped
    into the velodyne-ish odometry frame like kittiHelper :95-111)."""
    rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
    n = rows.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :4] = rows
    if remap_to_velo:
        R = R_CAM_TO_VELO
        for i in range(n):
            T[i, :3, :3] = R @ T[i, :3, :3] @ R.T
            T[i, :3, 3] = R @ T[i, :3, 3]
    return T


class KittiSequence:
    """Iterates (timestamp, scan[N,4]) over a KITTI odometry sequence dir
    layout: sequence_dir/{times.txt, velodyne/*.bin}, poses optional."""

    def __init__(self, sequence_dir: str, pose_file: Optional[str] = None,
                 max_frames: Optional[int] = None):
        self.dir = sequence_dir
        self.times = read_times(sequence_dir)
        self.velodyne_dir = os.path.join(sequence_dir, "velodyne")
        self.n_frames = len(self.times)
        if max_frames is not None:
            self.n_frames = min(self.n_frames, max_frames)
        self.gt_poses = read_poses(pose_file) if pose_file else None

    def __len__(self) -> int:
        return self.n_frames

    def scan(self, i: int) -> np.ndarray:
        return read_velodyne_bin(
            os.path.join(self.velodyne_dir, f"{i:06d}.bin")
        )

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for i in range(self.n_frames):
            yield float(self.times[i]), self.scan(i)
