"""MulRan dataset reader (Ouster OS1-64 + consumer GPS).

The reference consumes MulRan through the external file_player_mulran
(README.md:43-48); this reads the dataset layout directly:
  sequence_dir/sensor_data/Ouster/<stamp_ns>.bin  (float32 x,y,z,i quads)
  sequence_dir/sensor_data/gps.csv                (stamp_ns, lat, lon, alt, ...)
  sequence_dir/global_pose.csv                    (stamp_ns, 3x4 row-major GT)
GPS altitude feeds the altitude-only GPS factor
(src/laserPosegraphOptimization.cpp:302-308,674-681).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def read_ouster_bin(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


class MulranSequence:
    def __init__(self, sequence_dir: str, max_frames: Optional[int] = None):
        self.dir = sequence_dir
        ouster = os.path.join(sequence_dir, "sensor_data", "Ouster")
        self.files: List[str] = sorted(glob.glob(os.path.join(ouster, "*.bin")))
        if max_frames is not None:
            self.files = self.files[:max_frames]
        self.stamps = np.array(
            [int(os.path.splitext(os.path.basename(f))[0]) for f in self.files],
            dtype=np.int64,
        )
        self.gps = self._read_gps()
        self.gt = self._read_global_pose()

    def _read_gps(self):
        path = os.path.join(self.dir, "sensor_data", "gps.csv")
        if not os.path.exists(path):
            return None
        raw = np.loadtxt(path, delimiter=",")
        # columns: stamp, lat, lon, alt, [cov...]
        return {"stamp": raw[:, 0].astype(np.int64), "alt": raw[:, 3]}

    def _read_global_pose(self):
        path = os.path.join(self.dir, "global_pose.csv")
        if not os.path.exists(path):
            return None
        raw = np.loadtxt(path, delimiter=",")
        stamps = raw[:, 0].astype(np.int64)
        n = len(raw)
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, :4] = raw[:, 1:13].reshape(n, 3, 4)
        return {"stamp": stamps, "poses": T}

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for f, s in zip(self.files, self.stamps):
            yield s * 1e-9, read_ouster_bin(f)

    def gps_events(self) -> List[Tuple[float, float]]:
        """(time_s, altitude) pairs for SlamSystem.add_gps."""
        if self.gps is None:
            return []
        return [
            (s * 1e-9, float(a))
            for s, a in zip(self.gps["stamp"], self.gps["alt"])
        ]
