"""What the traffic drivers share: the cell's inputs from the seed, the
program's configuration from the configuration file, and the sampling of
the frames whose outputs are compared."""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from benchlib import synthetic


class Context(NamedTuple):
    cell: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    seed: int
    device: torch.device

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def slam_config(self):
        """The program's SlamConfig from the configuration file's `settings`."""
        from scaloam_tpu_torch import config as pconfig

        return pconfig.from_dict(self.config["settings"])

    def rng(self, purpose: int) -> np.random.Generator:
        """A host generator for one purpose of this seed."""
        return np.random.default_rng([int(self.seed) % (1 << 64), purpose])


def make_scans(ctx: Context, course: synthetic.Course, cfg) -> List[np.ndarray]:
    """The course's scans, ray-cast on the device from the seed and copied
    to host memory once."""
    p = ctx.params
    gen = synthetic.generator(ctx.seed, ctx.device)
    world = synthetic.make_world(gen, p["boxes"], p["extent_m"])
    scans = synthetic.simulate_scans(world, course, gen, n_scans=cfg.sensor.n_scans,
                                     n_azimuth=p["columns"], lidar_type=cfg.sensor.lidar_type,
                                     noise=p["noise_m"])
    return synthetic.scans_to_host(scans)


def pose_to_host(pose) -> np.ndarray:
    """A pose (or stacked poses) read to the host in one transfer."""
    return torch.cat([pose.quat, pose.trans], dim=-1).cpu().numpy()


def sample_frames(rng: np.random.Generator, n_frames: int, count: int, must=()) -> set:
    """`count` frame indices of [0, n_frames) drawn from rng, with `must`
    among them."""
    chosen = set(must)
    rest = [i for i in range(n_frames) if i not in chosen]
    extra = max(0, min(count - len(chosen), len(rest)))
    return chosen | set(int(i) for i in rng.choice(rest, size=extra, replace=False))


class Timer:
    """Host seconds of one scan: from handing the scan to the entry until
    its pose is on the host."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
