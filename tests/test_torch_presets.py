"""Every sensor preset through the port against the JAX reference, on the CPU.

- The front end at each of the four presets (`vlp16`, `hdl32`,
  `mulran_os1_64`, `kitti_hdl64`), cut to small capacities as
  `__graft_entry__.py` cuts kitti, but keeping each preset's `lidar_type`,
  `n_scans` and `minimum_range` (so its ring-id branch and its near
  points): 3 frames of `tests/test_presets.py`'s scene through
  `FrontEnd.step` against the reference's `frontend_step`. Feature picks
  exact (the less-sharp and less-flat clouds, coordinates within 1e-4),
  odometry and mapped poses within 5e-4 (quaternion) / 5e-3 m, the same
  keyframe gate and keyframe cloud size.
- The port's `MulranSequence` against the reference's on files in
  MulRan's layout: stamps, points, GPS events and ground truth equal.
- The port's CLI over a tiny MulRan-layout `vlp16` sequence with
  `--use-gps --device cpu`: exit 0, GPS factors in the graph, finite poses.
- `slow`: tests/test_gps_e2e.py's climbing scene with its 4 Hz GPS
  through both `SlamSystem`s: the same keyframes and GPS factors, mapped
  poses and optimised keyframes within 5e-4 / 5e-3 m.

The reference's feature selection runs its Pallas kernel in interpret
mode, as in tests/test_torch_frontend.py.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.io import mulran as jmulran
from scaloam_tpu.models import frontend as jfront, pipeline as jpipe
from scaloam_tpu.ops import features as jfeat
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.types import LidarScan as JScan
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig, run as trun
from scaloam_tpu_torch.io import mulran as tmulran
from scaloam_tpu_torch.models import frontend as tfront, pipeline as tpipe
from scaloam_tpu_torch.ops import features as tfeat
from scaloam_tpu_torch.types import LidarScan as TScan

Q_TOL, T_TOL = 5e-4, 5e-3
PRESETS = ["vlp16", "hdl32", "mulran_os1_64", "kitti_hdl64"]


def _reduced(preset):
    """The preset at __graft_entry__'s reduced capacities and a small grid
    map; lidar_type, n_scans and minimum_range stay the preset's."""
    cfg = jconfig.PRESETS[preset]()
    return cfg.replace(
        sensor=dataclasses.replace(
            cfg.sensor, max_points=min(cfg.sensor.max_points, 32768), max_points_per_ring=512),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=512, max_less_sharp=2048,
            max_flat=1024, max_less_flat=8192),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192),
    )


@pytest.fixture(scope="module")
def pallas_interpret():
    """Route the reference's selection kernel through interpret mode."""
    orig = jsel.select_features

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jsel.select_features = interp
    yield
    jsel.select_features = orig


def _assert_pose(got, want, what):
    q, wq = got.quat.numpy(), np.asarray(want.quat)
    if np.dot(q, wq) < 0:
        q = -q
    np.testing.assert_allclose(q, wq, atol=Q_TOL, rtol=0, err_msg=what)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=T_TOL, rtol=0,
                               err_msg=what)


def _assert_cloud(got, want, what):
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m, err_msg=what)
    np.testing.assert_array_equal(got.ring.numpy(), np.asarray(want.ring), err_msg=what)
    np.testing.assert_allclose(got.xyz.numpy()[m], np.asarray(want.xyz)[m], atol=1e-4, rtol=0,
                               err_msg=what)
    return int(m.sum())


@pytest.mark.parametrize("preset", PRESETS)
def test_frontend_matches_reference_at_preset(preset, pallas_interpret):
    """Each frame's picks are read from the odometry state, which keeps the
    frame's less-sharp (every corner pick) and less-flat clouds: one JAX
    program a preset, since tracing the interpret-mode kernel dominates."""
    jcfg = _reduced(preset)
    tcfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    s = jcfg.sensor
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=4, n_boxes=40, extent=50.0), n_frames=3, speed=0.8,
        radius=30.0, n_scans=s.n_scans, n_azimuth=512, lidar_type=s.lidar_type, seed=11)
    jstate = jfront.init_state(jcfg)
    fe = tfront.FrontEnd(tcfg, device="cpu")
    for i, pts in enumerate(scans):
        jstate, jout = jfront.frontend_step(jstate, JScan.from_numpy(pts, s.max_points), jcfg)
        tout = fe.step(*TScan.from_numpy(pts, s.max_points, "cpu"))
        what = f"{preset} frame {i}"
        n_corner = _assert_cloud(fe.state.o.last_corner, jstate.o.last_corner, what + " less_sharp")
        n_surf = _assert_cloud(fe.state.o.last_surf, jstate.o.last_surf, what + " less_flat")
        assert n_corner > 0 and n_surf > 100, (what, n_corner, n_surf)
        _assert_pose(tout.odom_world, jout.odom_world, what + " odometry")
        _assert_pose(tout.mapped_pose, jout.mapped_pose, what + " mapped pose")
        assert bool(tout.fire) == bool(jout.fire), what
        assert int(tout.kf_mask.sum()) == int(np.asarray(jout.kf_mask).sum()), what
    assert np.linalg.norm(tout.mapped_pose.trans.numpy()) < 10.0


def _write_mulran(root, scans, gt, gps_alt):
    """A sequence in MulRan's on-disk layout: Ouster quads named by their
    nanosecond stamps at 10 Hz, gps.csv at 4 Hz, global_pose.csv."""
    ouster = os.path.join(root, "sensor_data", "Ouster")
    os.makedirs(ouster)
    t0 = 1_561_000_000_000_000_000
    stamps = t0 + np.arange(len(scans), dtype=np.int64) * 100_000_000
    rng = np.random.default_rng(0)
    for st, pts in zip(stamps, scans):
        quad = np.concatenate([pts[:, :3], rng.uniform(0, 1, (len(pts), 1))], 1)
        quad.astype(np.float32).tofile(os.path.join(ouster, f"{st}.bin"))
    gps_t = t0 + np.arange(0, len(scans) * 100_000_000, 250_000_000, dtype=np.int64)
    with open(os.path.join(root, "sensor_data", "gps.csv"), "w") as f:
        for st in gps_t:
            f.write(f"{st},37.5,127.0,{gps_alt:.4f},0.1,0,0,0,0.1,0,0,0,0.1\n")
    with open(os.path.join(root, "global_pose.csv"), "w") as f:
        for st, T in zip(stamps, gt):
            f.write(f"{st}," + ",".join(f"{v:.9f}" for v in T[:3, :4].reshape(-1)) + "\n")
    return stamps


def _vlp16_drive(n_frames):
    return synthetic.simulate_trajectory(
        synthetic.make_world(seed=5, n_boxes=40, extent=30.0), n_frames=n_frames, speed=1.0,
        radius=25.0, n_scans=16, n_azimuth=720, seed=21, lidar_type="VLP16")


def test_mulran_reader_matches_reference(tmp_path):
    scans, gt = _vlp16_drive(3)
    stamps = _write_mulran(str(tmp_path), scans, gt, gps_alt=31.25)
    want = jmulran.MulranSequence(str(tmp_path))
    got = tmulran.MulranSequence(str(tmp_path))
    np.testing.assert_array_equal(got.stamps, want.stamps)
    np.testing.assert_array_equal(got.stamps, stamps)
    assert len(got) == len(want) == 3
    for (tg, pg), (tw, pw), pts in zip(got, want, scans):
        assert tg == tw
        assert pg.dtype == np.float32 and pg.shape == (len(pts), 4)
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(pg[:, :3], pts[:, :3].astype(np.float32))
    assert got.gps_events() == want.gps_events() and len(got.gps_events()) == 2
    np.testing.assert_array_equal(got.gt["stamp"], want.gt["stamp"])
    np.testing.assert_array_equal(got.gt["poses"], want.gt["poses"])
    np.testing.assert_allclose(got.gt["poses"], gt, atol=1e-8)
    assert len(tmulran.MulranSequence(str(tmp_path), max_frames=2)) == 2


def test_cli_mulran_with_gps_on_cpu(tmp_path, capsys, monkeypatch):
    """--mulran-dir with --use-gps: the GPS events reach the graph as
    altitude factors (associated at keyframe time, first-fix offset)."""
    scans, gt = _vlp16_drive(6)
    seq = str(tmp_path / "seq")
    _write_mulran(seq, scans, gt, gps_alt=31.25)
    systems = []

    class Spy(tpipe.SlamSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            systems.append(self)

    monkeypatch.setattr(tpipe, "SlamSystem", Spy)
    out = str(tmp_path / "out")
    argv = ["--preset", "vlp16", "--mulran-dir", seq, "--use-gps", "--keyframe-gap", "0.5",
            "--device", "cpu", "--out", out]
    assert trun.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 6 and res["keyframes"] >= 4
    (sys_,) = systems
    assert int(sys_.graph.gps_valid.sum()) >= res["keyframes"] // 3
    assert sys_._gps_alt_offset == 31.25  # the first fix's altitude
    poses = np.loadtxt(os.path.join(out, "optimized_poses.txt"))
    assert poses.shape == (res["keyframes"], 12) and np.isfinite(poses).all()


@pytest.mark.slow
def test_gps_scene_through_both_systems(pallas_interpret):
    """tests/test_gps_e2e.py's scene and configuration (a reduced vlp16)."""
    cfg = jconfig.vlp16()
    cfg = cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=1024,
                                   minimum_range=1.0),
        features=dataclasses.replace(cfg.features, use_pallas_selection="on"),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=24, grid_z=8, corner_cell_cap=16,
            surf_cell_cap=32, max_corner_input=1024, max_surf_input=4096),
        scancontext=dataclasses.replace(cfg.scancontext, max_keyframes=64, max_input_points=16384),
        pgo=dataclasses.replace(
            cfg.pgo, keyframe_meter_gap=1.0, max_keyframes=64, max_loops=8,
            keyframe_cloud_capacity=16384, odom_trans_variance=1e-2, gps_z_variance=0.01,
            cauchy_k=100.0, gn_iterations=8, optimize_every_n_keyframes=2),
    )
    scans, gt = synthetic.simulate_trajectory(
        synthetic.make_world(seed=5, n_boxes=40, extent=30.0), n_frames=30, speed=1.0,
        radius=40.0, n_scans=16, n_azimuth=720, seed=21, lidar_type="VLP16", climb=0.06)
    js = jpipe.SlamSystem(cfg)
    ts = tpipe.SlamSystem(tconfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    z0 = float(gt[0, 2, 3]) + 30.0  # an absolute altitude
    gps_t = 0.0
    for i, pts in enumerate(scans):
        t = 0.1 * i
        while gps_t <= t:
            js.add_gps(gps_t, z0)
            ts.add_gps(gps_t, z0)
            gps_t += 0.25
        jr, tr = js.process_scan(pts, time=t), ts.process_scan(pts, time=t)
        assert tr.is_keyframe == jr.is_keyframe, i
        _assert_pose(tr.mapped_pose, jr.mapped_pose, f"frame {i} mapped")
    n = len(js.keyframes)
    assert n == len(ts.keyframes) >= 10
    np.testing.assert_array_equal(ts.graph.gps_valid.numpy()[:n], np.asarray(js.graph.gps_valid)[:n])
    np.testing.assert_allclose(ts.graph.gps_z.numpy()[:n], np.asarray(js.graph.gps_z)[:n],
                               atol=1e-6, rtol=0)
    assert ts._gps_alt_offset == js._gps_alt_offset == z0
    assert int(ts.graph.gps_valid.sum()) >= n // 3
    # The stiff GPS weighting carries the solve's summation order to ~2e-3 m.
    np.testing.assert_allclose(ts.optimized_poses()[:, :3, 3], js.optimized_poses()[:, :3, 3],
                               atol=T_TOL, rtol=0)


# Each sensor's ring bounds (degrees of elevation) as the reference's
# _ring_id draws them, and its ring count.
_RING_BOUNDS = {
    "VLP16": (16, [2.0 * k - 16.0 for k in range(17)]),
    "HDL32": (32, [4.0 * k / 3.0 - 92.0 / 3.0 for k in range(33)]),
    "HDL64": (64, [2.0 - (k + 0.5) / 3.0 for k in range(33)]
              + [-8.83 - (k + 0.5) / 2.0 for k in range(32)] + [2.0, -8.83, -24.33]),
    "OS1-64": (64, [2.0 * k - 23.5 for k in range(25)]),
}


@pytest.mark.parametrize("lidar", sorted(_RING_BOUNDS))
def test_ring_ids_on_ring_bounds_match_reference(lidar):
    """Points whose elevation lies on a ring bound, and a few float32 ulps
    of z around it: the ring id (and its validity) is decided by the last
    ulp of the angle, and the port's must be the compiled reference's (its
    C library's atan2f, `angle + c` as one fused multiply-add). The
    synthetic OS1-64 puts whole beams on such bounds."""
    n_scans, bounds = _RING_BOUNDS[lidar]
    rng = np.random.default_rng(0)
    el = np.radians(np.repeat(np.asarray(bounds), 64))
    r = rng.uniform(5.0, 80.0, el.size)
    az = rng.uniform(-np.pi, np.pi, el.size)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
                   -1).astype(np.float32)
    steps = rng.integers(-3, 4, el.size)
    xyz[:, 2] = xyz[:, 2] + steps * np.spacing(np.abs(xyz[:, 2]))
    want = jax.jit(jfeat._ring_id, static_argnums=(1, 2))(xyz, lidar, n_scans)
    got = tfeat._ring_id(torch.from_numpy(xyz), lidar, n_scans)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
