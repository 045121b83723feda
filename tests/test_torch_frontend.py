"""The port's front end (scaloam_tpu_torch) against the JAX reference.

Feature extraction, single odometry / mapping steps from a state carried
across with convert.state_from_numpy, and the fused per-scan step over a
short synthetic drive, all on the CPU at a reduced HDL-64 configuration.

The reference's feature selection runs its Pallas kernel in interpret
mode (its CPU default is the XLA branch, which differs at subregion
boundaries by design). extract_features is jit-cached on the config, so
this file uses a config no other trace uses.

Tolerances: extraction is exact (same picks, same compaction) with
coordinates within 1e-4; poses within 5e-4 (quaternion) and 5e-3 m; counts
within 1%. Both rank 2-NN candidates by |q|^2 + |t|^2 - 2 q.t, so
near-tie candidates agree; the sparse 250-azimuth drive pins that (ranking
by direct differences moved its frame-1 translation by 1.7e-2 m).
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import frontend as jfront, mapping as jmap, odometry as jodo
from scaloam_tpu.ops import features as jfeat
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.types import LidarScan as JScan, Pose as JPose
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import frontend as tfront, mapping as tmap, odometry as todo
from scaloam_tpu_torch.ops import features as tfeat
from scaloam_tpu_torch.ops.kernels import gn_odometry, selection as tsel
from scaloam_tpu_torch.types import LidarScan as TScan, Pose as TPose

REPO = pathlib.Path(__file__).resolve().parents[1]
Q_TOL, T_TOL = 5e-4, 5e-3
# One odometry step from a shared state: the port ranks and rounds its 2-NN
# distances as the reference does, so it stays within the reference's own
# gap between its XLA and Pallas odometry paths (4.2e-7 m at full-width
# kitti_hdl64, tools/torch_departure_probe.py).
ODOM_Q_TOL, ODOM_T_TOL = 1e-5, 1e-5


def _config():
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=768,
            max_less_sharp=2048, max_flat=1536, max_less_flat=8192,
        ),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096,
        ),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192),
    )


JCFG = _config()
TCFG = tconfig.from_dict(dataclasses.asdict(JCFG))


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


def _scans(n_frames):
    world = synthetic.make_world(seed=8)
    return synthetic.simulate_trajectory(
        world, n_frames=n_frames, speed=0.8, radius=25.0, n_azimuth=256, seed=3
    )


def _host(tree):
    """Copy a JAX tree to numpy (the step donates its state buffers)."""
    return jax.tree.map(np.array, tree)


def _run_reference(scans):
    """JAX front end over the scans: numpy states before each frame, outputs."""
    state = jfront.init_state(JCFG)
    states, outs = [], []
    for s in scans:
        states.append(_host(state))
        state, out = jfront.frontend_step(state, JScan.from_numpy(s, JCFG.sensor.max_points), JCFG)
        outs.append(_host(out))
    return states, outs


@pytest.fixture(scope="module")
def drive(pallas_interpret):
    scans, _ = _scans(3)
    states, outs = _run_reference(scans)
    return scans, states, outs


def _tscan(points):
    return TScan.from_numpy(points, TCFG.sensor.max_points, "cpu")


def _assert_pose(got, want, what, q_tol=Q_TOL, t_tol=T_TOL):
    q, wq = got.quat.numpy(), np.asarray(want.quat)
    if np.dot(q, wq) < 0:
        q = -q
    np.testing.assert_allclose(q, wq, atol=q_tol, rtol=0, err_msg=what)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=t_tol, rtol=0, err_msg=what)


def _assert_count(got, want, what):
    got, want = int(got), int(want)
    assert abs(got - want) <= max(1, 0.01 * want), (what, got, want)


def test_extract_features_matches_reference(drive):
    scans = drive[0]
    want = jfeat.extract_features(JScan.from_numpy(scans[1], JCFG.sensor.max_points), JCFG)
    got = tfeat.extract_features(_tscan(scans[1]), TCFG)
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        w, g = getattr(want, name), getattr(got, name)
        m = np.asarray(w.mask)
        np.testing.assert_array_equal(g.mask.numpy(), m, err_msg=name)
        assert m.sum() > 0, name
        np.testing.assert_allclose(g.xyz.numpy()[m], np.asarray(w.xyz)[m], atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_array_equal(g.ring.numpy(), np.asarray(w.ring), err_msg=name)
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_array_equal(got.full.count.numpy(), np.asarray(want.full.count))


def test_selection_matches_reference(drive, pallas_interpret):
    """The five selection outputs inside extract_features, exactly: the
    reference's are captured at run time from its interpret-mode kernel
    (a config with an unrelated field changed forces a fresh trace)."""
    cfg = JCFG.replace(runtime=dataclasses.replace(JCFG.runtime, stage_budget_ms=99.0))
    captured = []
    interp = jsel.select_features

    def capture(*a, **k):
        out = interp(*a, **k)
        jax.debug.callback(lambda *v: captured.append([np.array(x) for x in v]), *out)
        return out

    jsel.select_features = capture
    try:
        want_feats = jfeat.extract_features(JScan.from_numpy(drive[0][1], JCFG.sensor.max_points), cfg)
        jax.block_until_ready(want_feats)
    finally:
        jsel.select_features = interp
    assert len(captured) == 1
    feat = TCFG.features
    si = tfeat.selection_inputs(_tscan(drive[0][1]), TCFG)
    got = tsel.select_features(
        si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep,
        n_sub=feat.n_subregions, n_corner=feat.less_sharp_per_subregion,
        n_flat=feat.flat_per_subregion, curv_thr=feat.curvature_threshold,
    )
    for name, w, g in zip(("corner_idx", "corner_ok", "flat_idx", "flat_ok", "labels"), captured[0], got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_odometry_and_mapping_steps_from_shared_state(drive):
    """Both implementations start frame 2 from the reference's state after
    frame 1, carried across with convert.state_from_numpy."""
    scans, states = drive[0], drive[1]
    jstate = jax.tree.map(jnp.asarray, states[2])
    tstate = convert.state_from_numpy(states[2], "cpu")
    jf = jfeat.extract_features(JScan.from_numpy(scans[2], JCFG.sensor.max_points), JCFG)
    tf = tfeat.extract_features(_tscan(scans[2]), TCFG)

    jo_state, jo = jodo.odometry_step(jstate.o, jf, JCFG)
    to_state, to = todo.odometry_step(tstate.o, tf, TCFG)
    _assert_pose(to.world, jo.world, "odometry world", ODOM_Q_TOL, ODOM_T_TOL)
    _assert_pose(to.rel, jo.rel, "odometry rel", ODOM_Q_TOL, ODOM_T_TOL)
    _assert_count(to.n_corner_corr, jo.n_corner_corr, "corner correspondences")
    _assert_count(to.n_surf_corr, jo.n_surf_corr, "surf correspondences")
    assert int(to_state.frame_idx) == int(jo_state.frame_idx)

    # Mapping from the same state, odometry pose and clouds.
    odom = convert.pose_from_numpy(_host(jo.world), "cpu")
    jm_state, jm = jmap.mapping_step(jstate.m, jo.world, jf.less_sharp, jf.less_flat, JCFG)
    tm_state, tm = tmap.mapping_step(tstate.m, odom, tf.less_sharp, tf.less_flat, TCFG)
    _assert_pose(tm.pose, jm.pose, "mapped pose")
    _assert_count(tm.n_corner_corr, jm.n_corner_corr, "map corner correspondences")
    _assert_count(tm.n_surf_corr, jm.n_surf_corr, "map surf correspondences")
    _assert_count(tm.map_corner_count, jm.map_corner_count, "corner map size")
    _assert_count(tm.map_surf_count, jm.map_surf_count, "surf map size")
    assert int(jm.n_surf_corr) > 0


def test_sparse_drive_odometry_ranks_candidates_like_reference(pallas_interpret):
    """Frame 1 of the seed-40, 250-azimuth drive from the reference's state:
    the solve is sensitive to how near-tie 2-NN candidates rank."""
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=8), n_frames=2, speed=0.8, radius=25.0,
        n_azimuth=250, seed=40)
    jf = [jfeat.extract_features(JScan.from_numpy(s, JCFG.sensor.max_points), JCFG) for s in scans]
    js, _ = jodo.odometry_step(jodo.init_state(JCFG), jf[0], JCFG)
    host = _host(js)
    _, jo = jodo.odometry_step(js, jf[1], JCFG)
    ts = convert.odometry_state_from_numpy(host, "cpu")
    _, to = todo.odometry_step(ts, tfeat.extract_features(_tscan(scans[1]), TCFG), TCFG)
    _assert_pose(to.rel, jo.rel, "frame-1 rel", ODOM_Q_TOL, ODOM_T_TOL)


def _check_drive(scans, outs):
    fe = tfront.FrontEnd(TCFG, device="cpu")
    for i, (s, want) in enumerate(zip(scans, outs)):
        got = fe.step(*_tscan(s))
        _assert_pose(got.odom_world, want.odom_world, f"frame {i} odom_world")
        _assert_pose(got.mapped_pose, want.mapped_pose, f"frame {i} mapped_pose")
        assert bool(got.fire) == bool(want.fire), i
        _assert_count(got.kf_mask.sum(), np.sum(want.kf_mask), f"frame {i} keyframe cloud")
    return fe


def test_frontend_step_tracks_reference(drive):
    scans, _, outs = drive
    fe = _check_drive(scans, outs)
    assert fe.state.o.initialized and int(fe.state.o.frame_idx) == len(scans)


@pytest.mark.slow
def test_frontend_step_tracks_reference_8_frames(pallas_interpret):
    scans, _ = _scans(8)
    _check_drive(scans, _run_reference(scans)[1])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "scaloam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(p.relative_to(REPO)) for p in files}
    for module in ("runtime/queues.py", "runtime/pipeline.py", "utils/metrics.py",
                   "utils/viz.py", "utils/mapmerge.py", "io/native_loader.py"):
        assert f"scaloam_tpu_torch/{module}" in names, module
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "scaloam_tpu"), (path, mod)


def test_entry_points_require_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tfront.FrontEnd(TCFG)
    with pytest.raises(RuntimeError):
        TScan.from_numpy(np.zeros((4, 3), np.float32), 8)


def test_deskew_path_runs_with_entry_a_gated_off(monkeypatch):
    """The de-skew path (distortion=True), once refused, runs: K2 entry A is
    gated off there as the reference gates its kernel off, and called with
    distortion off (tests/test_torch_deskew.py holds the path to JAX)."""
    calls = []
    entry_a = gn_odometry.associate_and_solve

    def spy(*a, **k):
        calls.append(1)
        return entry_a(*a, **k)

    monkeypatch.setattr(gn_odometry, "associate_and_solve", spy)
    scans = _scans(2)[0]
    for distortion, want in ((True, 0), (False, 1)):
        cfg = TCFG.replace(odometry=dataclasses.replace(TCFG.odometry, distortion=distortion))
        state = todo.init_state(cfg, "cpu")
        calls.clear()
        for s in scans:
            state, out = todo.odometry_step(state, tfeat.extract_features(_tscan(s), cfg), cfg)
        assert len(calls) == want, distortion
        assert np.isfinite(out.world.trans.numpy()).all() and float(out.n_surf_corr) > 0


def test_candidate_reranks_rank_near_ties_like_reference():
    """Odometry's pick of the nearer cached candidate and mapping's re-rank
    of its 8 cached neighbours, on candidates mirrored about each point:
    the compiled reference's squared distances (fused multiply-add chains)
    decide, so the port picks and ranks as it does."""
    rng = np.random.default_rng(6)
    q = rng.uniform(-60, 60, (2000, 3)).astype(np.float32)
    e = rng.normal(0, 0.3, (2000, 3)).astype(np.float32)
    cand = np.stack([q + e, q - e], 1).astype(np.float32)
    want = jax.jit(jodo._pick1)(q, cand)
    got = todo._pick1(torch.tensor(q), torch.tensor(cand))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    e8 = rng.normal(0, 0.3, (2000, 4, 3)).astype(np.float32)
    nb8 = np.concatenate([q[:, None] + e8, q[:, None] - e8], 1).astype(np.float32)
    pose = (np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    rerank = jax.jit(jmap._rerank, static_argnums=(3,))
    want = rerank(JPose(*map(jnp.asarray, pose)), q, nb8, 5)
    got = tmap._rerank(TPose(*map(torch.tensor, pose)), torch.tensor(q), torch.tensor(nb8), 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
