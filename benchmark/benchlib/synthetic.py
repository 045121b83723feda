"""The benchmark's traffic generator: spinning-lidar sweeps of a box world,
ray-cast on the device from a seed.

A copy, in PyTorch, of the program's synthetic simulator (a ground plane
and axis-aligned boxes, one revolution a scan in stream order: azimuth
outer, ring inner, misses dropped), kept here so that a change to the
program cannot change the yardstick. The box world, each sensor's beam
ladder, the circle and figure-8 courses and the range noise are the
simulator's; the random draws come from one `torch.Generator` on the
device, seeded by the run's seed, so one seed gives one set of scans on
one kind of card. The ray cast runs in float64, a frame at a time.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


class World(NamedTuple):
    boxes: torch.Tensor  # [B, 2, 3] float64 (min, max) corners
    ground_z: float = 0.0


class Course(NamedTuple):
    """Sensor positions [F, 3] and yaws [F] (float64, host) of a drive."""

    pos: np.ndarray
    yaw: np.ndarray


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded by `seed` (any whole number that
    fits 64 bits, negative ones folded in)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_world(gen: torch.Generator, n_boxes: int = 60, extent: float = 70.0) -> World:
    """Boxes with centres uniform over [-extent, extent]^2 (those within 8 m
    of the origin dropped, so the course's start is clear), footprints of
    1-6 m and heights of 2-8 m."""
    dev = gen.device
    u = lambda *s: torch.rand(s, generator=gen, device=dev, dtype=torch.float64)
    centers = (u(n_boxes, 2) * 2.0 - 1.0) * extent
    sizes = 1.0 + 5.0 * u(n_boxes, 2)
    heights = 2.0 + 6.0 * u(n_boxes)
    keep = torch.linalg.vector_norm(centers, dim=1) > 8.0
    centers, sizes, heights = centers[keep], sizes[keep], heights[keep]
    zeros = torch.zeros_like(heights)[:, None]
    mins = torch.cat([centers - sizes / 2, zeros], dim=1)
    maxs = torch.cat([centers + sizes / 2, heights[:, None]], dim=1)
    return World(boxes=torch.stack([mins, maxs], dim=1))


def elevation_ladder(n_scans: int, lidar_type: str) -> np.ndarray:
    """Each sensor's beam elevations in degrees, from the top beam down.

    HDL64: an upper block of 1/3 degree steps from +2 and a lower block of
    1/2 degree steps from -8.83 (one ring id a beam). VLP16: 2 degrees over
    [-15, +15]. HDL32: 4/3 degrees over [-30.67, +10.67]. OS1-64: uniform
    over [-22.5, +22.5]. Any other: uniform over [-24, +2]."""
    if lidar_type == "HDL64" and n_scans == 64:
        return np.concatenate([2.0 - np.arange(32) / 3.0, -8.83 - np.arange(32) / 2.0])
    if lidar_type == "VLP16" and n_scans == 16:
        return 15.0 - 2.0 * np.arange(16)
    if lidar_type == "HDL32" and n_scans == 32:
        return 10.67 - (4.0 / 3.0) * np.arange(32)
    if lidar_type == "OS1-64" and n_scans == 64:
        return np.linspace(22.5, -22.5, 64)
    return np.linspace(2.0, -24.0, n_scans)


def circle_course(n_frames: int, step: float, radius: float) -> Course:
    """The first n_frames frames of a drive around a circle through
    the origin, `step` m a frame, heading along the travel, 1.8 m above the
    ground."""
    theta = step * np.arange(n_frames, dtype=np.float64) / radius
    pos = np.stack([radius * np.sin(theta), radius * (1 - np.cos(theta)),
                    np.full_like(theta, 1.8)], axis=1)
    return Course(pos=pos, yaw=theta)


def lap_radius(lap_frames: int, step: float) -> float:
    """The radius of a circle whose circumference is `lap_frames` frames of
    `step` m, so the lap closes on a whole number of frames."""
    return lap_frames * step / (2 * math.pi)


def figure8_course(n_frames: int, step: float, scale: float) -> Course:
    """A figure-eight (lemniscate) through the origin, stepped `step` m of
    arc a frame, heading along the travel: it crosses itself at the origin
    twice a cycle from different headings."""
    P = lambda t: np.array([scale * np.sin(t), scale * np.sin(t) * np.cos(t), 1.8])
    th, thetas = 0.0, []
    for _ in range(n_frames):
        thetas.append(th)
        d = P(th + 1e-4) - P(th - 1e-4)
        th += step / max(np.linalg.norm(d) / 2e-4, 1e-9)
    pos = np.stack([P(t) for t in thetas])
    yaw = np.array([math.atan2(*(P(t + 1e-4) - P(t - 1e-4))[1::-1]) for t in thetas])
    return Course(pos=pos, yaw=yaw)


def _ray_box(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Slab intersection: o [3], d [N, 3], boxes [B, 2, 3] -> nearest t [N]
    in front of the origin (inf where none)."""
    if boxes.shape[0] == 0:
        return torch.full(d.shape[:1], math.inf, dtype=d.dtype, device=d.device)
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (boxes[None, :, 0, :] - o) * inv[:, None, :]
    t1 = (boxes[None, :, 1, :] - o) * inv[:, None, :]
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0)
    inf = torch.full_like(tmin, math.inf)
    return torch.where(hit, tmin, inf).amin(dim=-1)


def simulate_scans(world: World, course: Course, gen: torch.Generator, *, n_scans: int,
                   n_azimuth: int, lidar_type: str, max_range: float = 80.0,
                   noise: float = 0.01) -> List[torch.Tensor]:
    """One revolution a frame of the course: [M, 3] float32 points in the
    sensor frame on the generator's device, misses dropped, with Gaussian
    range noise of `noise` m."""
    dev = gen.device
    f64 = torch.float64
    elev = torch.deg2rad(torch.as_tensor(elevation_ladder(n_scans, lidar_type), dtype=f64,
                                         device=dev))
    azim = torch.linspace(-math.pi + 1e-3, math.pi - 1e-3, n_azimuth + 1, dtype=f64,
                          device=dev)[:-1]
    a = azim.repeat_interleave(n_scans)
    e = elev.repeat(n_azimuth)
    # direction chosen so -atan2(y, x) == a, monotone over the stream
    d_sensor = torch.stack([torch.cos(e) * torch.cos(a), -torch.cos(e) * torch.sin(a),
                            torch.sin(e)], dim=1)
    scans = []
    for pos, yaw in zip(course.pos, course.yaw):
        cy, sy = math.cos(yaw), math.sin(yaw)
        d_world = torch.stack([cy * d_sensor[:, 0] - sy * d_sensor[:, 1],
                               sy * d_sensor[:, 0] + cy * d_sensor[:, 1], d_sensor[:, 2]], dim=1)
        o = torch.as_tensor(pos, dtype=f64, device=dev)
        t_box = _ray_box(o, d_world, world.boxes)
        down = d_world[:, 2] < -1e-6
        t_ground = torch.where(down, (world.ground_z - o[2]) / torch.where(down, d_world[:, 2], -1.0),
                               torch.full_like(t_box, math.inf))
        t = torch.minimum(t_box, t_ground)
        hit = torch.isfinite(t) & (t < max_range) & (t > 0.5)
        t = t + noise * torch.randn(t.shape, generator=gen, device=dev, dtype=f64)
        scans.append((d_sensor[hit] * t[hit, None]).to(torch.float32))
    return scans


def scans_to_host(scans: List[torch.Tensor]) -> List[np.ndarray]:
    """The scans as host arrays, copied in one transfer."""
    counts = [int(s.shape[0]) for s in scans]
    flat = torch.cat(scans).cpu().numpy()
    return list(np.split(flat, np.cumsum(counts)[:-1]))

