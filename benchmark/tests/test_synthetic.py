"""The traffic generator: seeded, each sensor's beams and columns, laps
that close."""

import math

import numpy as np
import pytest
import torch

from benchlib import synthetic

CPU = torch.device("cpu")


def _scans(seed, lidar="HDL64", columns=128, frames=2):
    gen = synthetic.generator(seed, CPU)
    world = synthetic.make_world(gen, 30, 40.0)
    course = synthetic.circle_course(frames, 1.0, 10.0)
    return synthetic.simulate_scans(world, course, gen, n_scans=64 if lidar != "VLP16" else 16,
                                    n_azimuth=columns, lidar_type=lidar)


def test_same_seed_gives_the_same_scans():
    big = 2**31 + 977
    a, b = _scans(big), _scans(big)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = _scans(big + 1)
    assert not all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("lidar,beams", [("HDL64", 64), ("OS1-64", 64), ("VLP16", 16)])
def test_beam_ladder_and_columns(lidar, beams):
    columns = 96
    gen = synthetic.generator(5, CPU)
    world = synthetic.World(boxes=torch.zeros((0, 2, 3), dtype=torch.float64))
    course = synthetic.Course(pos=np.array([[0.0, 0.0, 1.8]]), yaw=np.array([0.0]))
    pts = synthetic.simulate_scans(world, course, gen, n_scans=beams, n_azimuth=columns,
                                   lidar_type=lidar, noise=0.0)[0].double()
    # a ground plane alone: each beam that meets it within 80 m does so in
    # every column
    ladder = synthetic.elevation_ladder(beams, lidar)
    hits = ladder[(ladder < 0) & (1.8 / np.sin(np.deg2rad(-np.minimum(ladder, -1e-9))) < 80.0)]
    down = len(hits)
    assert down > 0 and pts.shape[0] == down * columns
    elev = torch.rad2deg(torch.asin(pts[:, 2] / pts.norm(dim=1)))
    want = np.sort(hits)
    got = np.unique(np.round(elev.numpy(), 3))
    np.testing.assert_allclose(got, want, atol=2e-3)
    azim = torch.unique(torch.round(torch.atan2(-pts[:, 1], pts[:, 0]) * 1e4))
    assert azim.numel() == columns


def test_a_lap_closes_on_a_whole_number_of_frames():
    lap, step = 128, 1.2
    r = synthetic.lap_radius(lap, step)
    c = synthetic.circle_course(lap + 1, step, r)
    np.testing.assert_allclose(c.pos[lap], c.pos[0], atol=1e-9)
    assert math.isclose(math.remainder(c.yaw[lap] - c.yaw[0], 2 * math.pi), 0.0, abs_tol=1e-12)
    assert np.allclose(np.linalg.norm(np.diff(c.pos[:, :2], axis=0), axis=1), 2 * r * math.sin(
        step / (2 * r)))


def test_figure8_steps_its_arc_length():
    c = synthetic.figure8_course(50, 1.0, 25.0)
    d = np.linalg.norm(np.diff(c.pos, axis=0), axis=1)
    assert np.all(np.abs(d - 1.0) < 0.05)  # a first-order step in the curve's parameter

