"""The port's synchronous system (scaloam_tpu_torch.models.pipeline.SlamSystem),
its CLI and its session artifacts against the JAX reference, on the CPU.

- An 8-frame drive at a reduced HDL-64 configuration with a 0.5 m keyframe
  gap: every frame a keyframe, an optimise every second keyframe. Same
  keyframe frames, mapped poses within 5e-4 (quaternion) / 5e-3 m, graph
  poses within 1e-3 m, ScanContext descriptors within 1e-4.
- The loop path: the same keyframes (the scenes of
  tests/test_scancontext.py) injected into both systems through
  `_add_keyframe_prepared`, then `_detect_and_verify_loop`: the same
  (curr, idx) and the loop factor within 1e-4 / 1e-3 m.
- Sessions: `save_session` writes the reference's files (KITTI poses and
  SCDs equal within 1e-6) and `resume` restores keyframes, descriptors and
  the loops from the g2o.
- The CLI on the CPU at the VLP-16 preset, its refusals and its JSON keys.

The reference's feature selection runs its Pallas kernel in interpret
mode, as in tests/test_torch_frontend.py. The full loop-closing drive is
marked slow.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import pipeline as jpipe, posegraph as jpg
from scaloam_tpu.ops import se3 as jse3
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.types import Pose as JPose
from scaloam_tpu.utils import synthetic
from scaloam_tpu.utils.evaluation import ate_rmse
from scaloam_tpu_torch import config as tconfig, convert, run as trun
from scaloam_tpu_torch.models import pipeline as tpipe, posegraph as tpg
from scaloam_tpu_torch.ops import se3 as tse3
from scaloam_tpu_torch.types import Pose as TPose
from torch_threads import two_threads  # noqa: F401  (autouse)

CPU = "cpu"


def _small(cfg, **pgo):
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=768,
            max_less_sharp=2048, max_flat=1536, max_less_flat=8192),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192, **pgo),
    )


def _port_cfg(jcfg):
    return tconfig.from_dict(dataclasses.asdict(jcfg))


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


def _assert_pose(got: TPose, want, qtol, ttol, what):
    q, wq = got.quat.numpy(), np.asarray(want.quat)
    sign = np.where(np.sum(q * wq, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(q * sign, wq, atol=qtol, rtol=0, err_msg=what)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=ttol, rtol=0,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------


def _drive_both(jcfg, scans, check_every_frame=True):
    js, ts = jpipe.SlamSystem(jcfg), tpipe.SlamSystem(_port_cfg(jcfg), device=CPU)
    for i, s in enumerate(scans):
        jr = js.process_scan(s, time=0.1 * i)
        tr = ts.process_scan(s, time=0.1 * i)
        if check_every_frame:
            assert tr.is_keyframe == jr.is_keyframe, i
            assert tr.loop_found == jr.loop_found, i
            _assert_pose(tr.mapped_pose, jr.mapped_pose, 5e-4, 5e-3, f"frame {i} mapped")
            _assert_pose(tr.odom_pose, jr.odom_pose, 5e-4, 5e-3, f"frame {i} odom")
    return js, ts


def test_slam_system_drive_matches_reference(pallas_interpret):
    jcfg = _small(jconfig.kitti_hdl64(), keyframe_meter_gap=0.5, max_keyframes=16, max_loops=4)
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=8), n_frames=8, speed=0.8, radius=25.0, n_azimuth=256, seed=3)
    js, ts = _drive_both(jcfg, scans)
    n = len(js.keyframes)
    assert n == len(ts.keyframes) >= 6
    assert [k.frame for k in ts.keyframes] == [k.frame for k in js.keyframes]
    assert n // jcfg.pgo.optimize_every_n_keyframes >= 2  # optimises ran
    np.testing.assert_allclose(ts.optimized_poses()[:, :3, 3], js.optimized_poses()[:, :3, 3],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.odometry_keyframe_poses(), js.odometry_keyframe_poses(),
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(ts.sc.db.descriptors.numpy()[:n],
                               np.asarray(js.sc.db.descriptors)[:n], atol=1e-4, rtol=0)
    for tk, jk in zip(ts.keyframes, js.keyframes):
        assert abs(len(tk.cloud) - len(jk.cloud)) <= max(1, 0.01 * len(jk.cloud))
        assert tk.intensity is not None and len(tk.intensity) == len(tk.cloud)


@pytest.mark.slow
def test_loop_closing_drive_matches_reference(pallas_interpret):
    """tests/test_pipeline_e2e.py's closed-loop drive (at a scan capacity
    that still holds every point) through both systems. At 1 m a frame the
    1 m keyframe gap sits on its threshold, so frames within the pose
    tolerance may gate differently: the two are held to the same outcome
    (loops closed, keyframe count within 10%, ATE within 5 cm of each
    other) and the port to the reference test's ATE bounds."""
    jcfg = jconfig.kitti_hdl64()
    jcfg = jcfg.replace(
        # 720 azimuths x 64 rings fit these capacities, so nothing is cut.
        sensor=dataclasses.replace(jcfg.sensor, minimum_range=1.0, max_points=65536,
                                   max_points_per_ring=768),
        mapping=dataclasses.replace(
            jcfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=8192),
        scancontext=dataclasses.replace(
            jcfg.scancontext, dist_threshold=0.35, num_exclude_recent=20,
            max_keyframes=256, max_input_points=32768),
        loop=dataclasses.replace(jcfg.loop, max_submap_points=32768, max_source_points=4096),
        pgo=dataclasses.replace(jcfg.pgo, keyframe_meter_gap=1.0, max_keyframes=256,
                                max_loops=32, gn_iterations=6),
    )
    scans, gt = synthetic.simulate_trajectory(
        synthetic.make_world(seed=11, n_boxes=50, extent=40.0), n_frames=70, speed=1.0,
        radius=10.0, n_azimuth=720, seed=100)
    js, ts = _drive_both(jcfg, scans, check_every_frame=False)
    assert len(ts.loops_found) >= 1 and len(js.loops_found) >= 1
    assert abs(len(ts.keyframes) - len(js.keyframes)) <= 0.1 * len(js.keyframes)
    gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])

    def ate(s, poses):
        return ate_rmse(poses, gt_rel[[k.frame for k in s.keyframes]])

    ate_port, ate_ref = ate(ts, ts.optimized_poses()), ate(js, js.optimized_poses())
    assert abs(ate_port - ate_ref) <= 0.05, (ate_port, ate_ref)
    assert ate_port < 0.5 and ate_port <= 1.5 * ate(ts, ts.odometry_keyframe_poses())


# ---------------------------------------------------------------------------
# the loop path
# ---------------------------------------------------------------------------


def _loop_cfg():
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(
        scancontext=dataclasses.replace(cfg.scancontext, num_exclude_recent=3, num_candidates=3,
                                        max_keyframes=64, dist_threshold=0.4),
        loop=dataclasses.replace(cfg.loop, coarse_source_points=512, coarse_target_points=2048,
                                 max_submap_points=32768, max_source_points=4096,
                                 coarse_iterations=15,
                                 icp_max_iterations=10),
        pgo=dataclasses.replace(cfg.pgo, max_keyframes=16, max_loops=4),
    )


KF_CAP = 40960


def _places():
    """tests/test_scancontext.py's drive: places 0..9 3 m apart, then place
    0 again, offset and rotated. Each as (padded cloud, mask, pose)."""
    world = synthetic.make_world(seed=7)
    spots = [((3.0 * i, 0.0), 0.1 * i, i) for i in range(10)] + [((0.3, 0.1), 0.8, 99)]
    out = []
    for (x, y), yaw, seed in spots:
        pts = synthetic.simulate_scan(world, np.array([x, y, 1.8]), yaw, n_azimuth=600, seed=seed)
        xyz = np.zeros((KF_CAP, 3), np.float32)
        xyz[: len(pts)] = pts[:KF_CAP]
        m = np.zeros(KF_CAP, bool)
        m[: len(pts)] = True
        q = np.array(jse3.rpy_to_quat(jnp.float32(0), jnp.float32(0), jnp.float32(yaw)))
        out.append((xyz, m, q, np.array([x, y, 0.0], np.float32)))
    return out


def _inject(js, ts, places):
    ext = np.zeros((KF_CAP, 1), np.float32)
    for k, (xyz, m, q, t) in enumerate(places):
        js._add_keyframe_prepared(jnp.asarray(xyz), jnp.asarray(m), jnp.asarray(ext),
                                  JPose(jnp.asarray(q), jnp.asarray(t)), 0.1 * k)
        ts._add_keyframe_prepared(torch.from_numpy(xyz), torch.from_numpy(m),
                                  torch.from_numpy(ext), TPose(torch.from_numpy(q),
                                                               torch.from_numpy(t)), 0.1 * k)


def test_loop_path_matches_reference():
    jcfg = _loop_cfg()
    js, ts = jpipe.SlamSystem(jcfg), tpipe.SlamSystem(_port_cfg(jcfg), device=CPU)
    places = _places()
    _inject(js, ts, places[:-1])
    assert js._detect_and_verify_loop() is None and ts._detect_and_verify_loop() is None
    _inject(js, ts, places[-1:])
    jl = js._detect_and_verify_loop()
    tl = ts._detect_and_verify_loop()
    assert tl == jl == (10, 0)
    want = JPose(js.graph.loop_rel.quat[0], js.graph.loop_rel.trans[0])
    got = TPose(ts.graph.loop_rel.quat[0], ts.graph.loop_rel.trans[0])
    _assert_pose(got, want, 1e-4, 1e-3, "loop factor")
    # the graph's loop tables and the optimised poses agree too
    assert int(ts.graph.n_loops) == 1
    jo = jpg.optimize(js.graph, jcfg.pgo)
    to = tpg.optimize(ts.graph, _port_cfg(jcfg).pgo)
    np.testing.assert_allclose(to.poses.trans.numpy()[:11], np.asarray(jo.poses.trans)[:11],
                               atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


def _session_cfg():
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(
        pgo=dataclasses.replace(cfg.pgo, max_keyframes=64, max_loops=8),
        scancontext=dataclasses.replace(cfg.scancontext, max_keyframes=64,
                                        max_input_points=4096),
    )


def _session_systems():
    """Both systems holding the same 6 keyframes and one loop, built as
    tests/test_session_resume.py builds its session."""
    jcfg = _session_cfg()
    js, ts = jpipe.SlamSystem(jcfg), tpipe.SlamSystem(_port_cfg(jcfg), device=CPU)
    rng = np.random.default_rng(7)
    cap = jcfg.scancontext.max_input_points
    pose_t = np.zeros(3, np.float32)
    q = np.array([np.cos(0.1), 0.0, 0.0, np.sin(0.1)], np.float32)
    for k in range(6):
        cloud = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
        intens = rng.uniform(0, 60, 300).astype(np.float32)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:300] = cloud
        m = np.zeros(cap, bool)
        m[:300] = True
        pose_t = pose_t + np.array([2.0, 0.1 * k, 0.0], np.float32)
        for s, mk, P, T, mod in ((js, jnp.asarray, JPose, jpg, jpipe),
                                 (ts, torch.from_numpy, TPose, tpg, tpipe)):
            s.keyframes.append(mod.Keyframe(cloud=cloud, time=0.1 * k, frame=k, intensity=intens))
            s.kf_times.append(0.1 * k)
            s.sc.make_and_save(mk(xyz), mk(m))
            s.graph = T.add_keyframe(s.graph, P(mk(q), mk(pose_t.copy())), np.float32(0.0),
                                     np.bool_(False), n_nodes=k)
    rel_q, rel_t = np.array([1.0, 0, 0, 0], np.float32), np.array([0.5, 0.0, 0.0], np.float32)
    js.graph = jpg.add_loop(js.graph, jnp.int32(5), jnp.int32(0),
                            JPose(jnp.asarray(rel_q), jnp.asarray(rel_t)), n_loops=0)
    ts.graph = tpg.add_loop(ts.graph, 5, 0, TPose(torch.from_numpy(rel_q),
                                                  torch.from_numpy(rel_t)), n_loops=0)
    for s in (js, ts):
        s.loops_found.append((5, 0))
    js.graph = jpg.optimize(js.graph, jcfg.pgo, cg_iters=32)
    ts.graph = tpg.optimize(ts.graph, _port_cfg(jcfg).pgo, cg_iters=32)
    return jcfg, js, ts


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_session_save_and_resume_match_reference(tmp_path):
    jcfg, js, ts = _session_systems()
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    js.save_session(jd)
    ts.save_session(td)
    assert _files(td) == _files(jd)
    assert {"times.txt", "optimized_poses.txt", "odom_poses.txt",
            "singlesession_posegraph.g2o"} <= set(_files(td))
    for name in ("optimized_poses.txt", "odom_poses.txt", "times.txt"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(td, name)),
                                   np.loadtxt(os.path.join(jd, name)), atol=1e-6, rtol=0)
    for f in _files(jd):
        if f.endswith(".scd"):
            np.testing.assert_allclose(np.loadtxt(os.path.join(td, f)),
                                       np.loadtxt(os.path.join(jd, f)), atol=1e-6, rtol=0)

    jr = jpipe.SlamSystem.resume(jd, jcfg)
    tr = tpipe.SlamSystem.resume(td, _port_cfg(jcfg), device=CPU)
    assert tr.loops_found == jr.loops_found == [(5, 0)]
    assert len(tr.keyframes) == 6 and int(tr.graph.n_nodes) == 6 and tr.sc._n == 6
    np.testing.assert_array_equal(tr.graph.loop_i.numpy()[:1], [5])
    np.testing.assert_allclose(tr.graph.loop_rel.trans.numpy()[0], [0.5, 0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(tr.optimized_poses(), jr.optimized_poses(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.sc.db.descriptors.numpy()[:6],
                               np.asarray(jr.sc.db.descriptors)[:6], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tr.keyframes[0].intensity, ts.keyframes[0].intensity, atol=1e-5)
    assert bool(tr.gate_state.initialized)
    # re-attaching to the resumed directory continues the session
    tr.attach_session_writer(td)
    assert tr._writer.n_written == 6


def test_system_state_carries_across_from_reference():
    jcfg, js, _ = _session_systems()
    host = jax.tree.map(np.asarray, js.graph)
    tree = {
        "graph": host, "sc_db": jax.tree.map(np.asarray, js.sc.db),
        "keyframes": [dict(cloud=k.cloud, intensity=k.intensity, time=k.time, frame=k.frame)
                      for k in js.keyframes],
        "gate": jax.tree.map(np.asarray, js.gate_state), "loops_found": js.loops_found,
        "gps_alt_offset": js._gps_alt_offset, "frame_idx": js.frame_idx,
    }
    ts = convert.system_from_numpy(tree, _port_cfg(jcfg), CPU)
    assert ts.sc._n == 6 and ts.loops_found == [(5, 0)]
    np.testing.assert_allclose(ts.optimized_poses(), js.optimized_poses(), atol=1e-6, rtol=0)
    assert ts.graph.loop_i.dtype == torch.int64


# ---------------------------------------------------------------------------
# entry points and the CLI
# ---------------------------------------------------------------------------


def test_entry_points_require_a_device_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.kitti_hdl64()
    with pytest.raises(RuntimeError):
        tpipe.SlamSystem(cfg)
    assert trun.main(["--synthetic", "2"]) == 2
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--backend-device", "1"],
                                  ["--backend-device", "1", "--async-pipeline"]])
def test_cli_refuses_backend_device_out_of_range(argv, capsys):
    assert trun.main(argv + ["--synthetic", "2", "--device", "cpu"]) == 2
    assert "out of range" in capsys.readouterr().err


def test_cli_async_pipeline_on_cpu(tmp_path, capsys):
    """--async-pipeline runs the threaded runtime; its result line carries
    dropped_frames, and the keyframes pair with their source frames."""
    out = str(tmp_path / "sess")
    argv = ["--preset", "vlp16", "--synthetic", "4", "--keyframe-gap", "0.5",
            "--synthetic-radius", "25", "--device", "cpu", "--async-pipeline", "--out", out]
    assert trun.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 4 and res["dropped_frames"] == 0 and res["keyframes"] >= 3
    assert np.isfinite(res["ate_rmse_optimized"]) and res["ate_rmse_optimized"] < 0.1
    assert len(np.loadtxt(os.path.join(out, "times.txt"))) == res["keyframes"]


def test_cli_needs_a_data_source(capsys):
    assert trun.main(["--device", "cpu"]) == 2
    assert "need --kitti-dir" in capsys.readouterr().err


def test_cli_synthetic_session_and_resume(tmp_path, capsys):
    out = str(tmp_path / "sess")
    argv = ["--preset", "vlp16", "--synthetic", "4", "--keyframe-gap", "0.5",
            "--synthetic-radius", "25", "--device", "cpu", "--out", out]
    assert trun.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("frames", "keyframes", "loops", "scans_per_sec", "degenerate_frames", "out",
                "ate_rmse_optimized", "ate_rmse_odometry"):
        assert key in res, key
    assert res["frames"] == 4 and res["keyframes"] >= 3
    assert np.isfinite(res["ate_rmse_optimized"])
    names = set(_files(out))
    assert {"times.txt", "optimized_poses.txt", "odom_poses.txt",
            "singlesession_posegraph.g2o", "live.html"} <= names
    assert sum(n.startswith("Scans") for n in names) == res["keyframes"]
    assert sum(n.startswith("SCDs") for n in names) == res["keyframes"]
    assert trun.main(argv[:-2] + ["--synthetic", "2", "--resume", out, "--out", out]) == 0
    res2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res2["keyframes"] >= res["keyframes"] + 1
    assert len(np.loadtxt(os.path.join(out, "times.txt"))) == res2["keyframes"]


def test_keyframe_materialises_device_cloud():
    xyz = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    mask = torch.tensor([True, False, True, False])
    ext = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    kf = tpipe.Keyframe(time=0.5, frame=3, dev=(xyz, mask, ext))
    np.testing.assert_array_equal(kf.cloud, xyz.numpy()[[0, 2]])
    np.testing.assert_array_equal(kf.intensity, [1.0, 3.0])
    assert (kf.time, kf.frame) == (0.5, 3)


def test_pose_matrices_match_reference_helpers():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    got = tpipe._pose_matrices(q, t)
    want = np.stack([jpipe._np_pose_matrix(q[k], t[k]) for k in range(5)])
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    R = got[:, :3, :3]
    qq = tse3.mat_to_quat(torch.from_numpy(R)).numpy()
    ref = np.stack([jpipe._np_mat_to_quat(R[k]) for k in range(5)])
    np.testing.assert_allclose(np.abs(np.sum(qq * ref, axis=1)), 1.0, atol=1e-9)
