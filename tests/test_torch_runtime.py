"""The port's threaded runtime (scaloam_tpu_torch.runtime) on the CPU.

- BoundedQueue keeps the reference's backpressure semantics.
- The kernel build (ops/kernels/_build.py) is safe from several threads.
- AsyncSlamPipeline, fused and separate, over 5 frames of a synthetic
  drive at the reduced HDL-64 configuration of __graft_entry__._small_cfg
  (32768 points, 512 per ring; mapping and backend capacities cut as in
  tests/test_torch_system.py): odometry and mapped poses match the JAX
  sync SlamSystem within 5e-4 (quaternion) / 5e-3 m with equal keyframe
  counts, and the odometry matches the port's own sync SlamSystem within
  1e-6 m (same operations in the same order).
- finish() right after feeding drains every frame; abort() leaves numpy
  results; SCManager's two-phase detect.

The reference's feature selection runs its Pallas kernel in interpret mode,
as in tests/test_torch_system.py. Neither side optimises in the sync runs
(optimize_every_n_keyframes is out of reach), so the JAX side compiles no
pose-graph tier; the async loop thread optimises on its 1 Hz cadence, which
moves no front-end output.
"""

import dataclasses
import os
import stat
import threading
import time

import numpy as np
import pytest
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import pipeline as jpipe
from scaloam_tpu.ops.pallas import selection as jsel
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig
from scaloam_tpu_torch.models import pipeline as tpipe, scancontext as tscm
from scaloam_tpu_torch.ops.kernels import _build
from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline
from scaloam_tpu_torch.runtime.queues import BoundedQueue
from torch_threads import two_threads  # noqa: F401  (autouse)

N_FRAMES = 5
Q_TOL, T_TOL = 5e-4, 5e-3


# ---------------------------------------------------------------------------
# queues
# ---------------------------------------------------------------------------


def _drop_oldest():
    q = BoundedQueue(maxlen=3)
    for i in range(5):
        q.put(i)
    assert q.dropped == 2 and q.get() == 2


def _get_latest():
    q = BoundedQueue(maxlen=10)
    for i in range(5):
        q.put(i)
    assert q.get_latest() == 4 and q.dropped == 4 and len(q) == 0


def _close_unblocks():
    q = BoundedQueue()
    threading.Timer(0.1, q.close).start()
    t0 = time.time()
    assert q.get(timeout=5.0) is None
    assert time.time() - t0 < 1.0 and q.closed


def _clear():
    q = BoundedQueue(maxlen=10)
    for i in range(4):
        q.put(i)
    assert q.clear() == 4 and q.dropped == 4 and len(q) == 0


@pytest.mark.parametrize("case", [_drop_oldest, _get_latest, _close_unblocks, _clear],
                         ids=lambda f: f.__name__.strip("_"))
def test_bounded_queue(case):
    case()


# ---------------------------------------------------------------------------
# the kernel build from several threads
# ---------------------------------------------------------------------------


def test_kernel_build_is_thread_safe(tmp_path, monkeypatch):
    """Four threads build at once: one library per source, no error, no
    temporary file left (each build writes its own temporary)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'sleep 0.2\necho built > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    errors = []

    def job():
        try:
            _build.build()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=job) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not errors
    built = sorted(os.listdir(tmp_path / "kernels"))
    assert len(built) == len(_build.SOURCES)
    assert all(name.endswith(".so") for name in built), built
    assert sorted(p.name for p in map(_build._lib_path, _build.SOURCES)) == built


# ---------------------------------------------------------------------------
# the pipeline against the sync drivers
# ---------------------------------------------------------------------------


def _jcfg(fused=True):
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=32768, max_points_per_ring=512),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=512, max_less_sharp=2048,
            max_flat=1024, max_less_flat=8192),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192, keyframe_meter_gap=0.5,
                                max_keyframes=16, max_loops=4, optimize_every_n_keyframes=1000),
        scancontext=dataclasses.replace(cfg.scancontext, max_keyframes=16),
        runtime=dataclasses.replace(cfg.runtime, fused_frontend=fused),
    )


def _tcfg(fused=True):
    return tconfig.from_dict(dataclasses.asdict(_jcfg(fused)))


@pytest.fixture(scope="module")
def scans():
    return synthetic.simulate_trajectory(
        synthetic.make_world(seed=8), n_frames=N_FRAMES, speed=0.8, radius=25.0,
        n_azimuth=256, seed=3)[0]


@pytest.fixture(scope="module")
def jax_sync(scans):
    """The JAX sync SlamSystem over the scans: odometry / mapped poses per
    frame as numpy, and the system."""
    orig = jsel.select_features

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jsel.select_features = interp
    try:
        js = jpipe.SlamSystem(_jcfg())
        poses = []
        for i, s in enumerate(scans):
            r = js.process_scan(s, time=0.1 * i)
            poses.append([np.asarray(x) for x in (r.odom_pose.quat, r.odom_pose.trans,
                                                  r.mapped_pose.quat, r.mapped_pose.trans)])
    finally:
        jsel.select_features = orig
    return js, poses


@pytest.fixture(scope="module")
def port_sync(scans):
    ts = tpipe.SlamSystem(_tcfg(), device="cpu")
    odom = [ts.process_scan(s, time=0.1 * i).odom_pose.trans.numpy()
            for i, s in enumerate(scans)]
    return ts, odom


def _run_async(scans, fused, drop_backlog=False):
    pipe = AsyncSlamPipeline(_tcfg(fused), drop_backlog=drop_backlog, device="cpu")
    assert pipe.fused == fused
    pipe.start()
    for i, s in enumerate(scans):
        pipe.feed(0.1 * i, s)
    pipe.finish(timeout=300.0)
    assert pipe.workers_alive == 0
    return pipe


def _quat_close(got, want):
    got = got * (1.0 if np.dot(got, want) >= 0 else -1.0)
    np.testing.assert_allclose(got, want, atol=Q_TOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
def test_async_pipeline_matches_sync_drivers(scans, jax_sync, port_sync, fused):
    js, want = jax_sync
    ts, port_odom = port_sync
    pipe = _run_async(scans, fused)
    assert pipe.dropped_frames == 0
    assert len(pipe.odom_results) == len(pipe.mapped_results) == N_FRAMES
    for i, ((_, odom), (_, mapped)) in enumerate(zip(pipe.odom_results, pipe.mapped_results)):
        assert isinstance(odom, np.ndarray) and isinstance(mapped, np.ndarray)
        np.testing.assert_allclose(odom, want[i][1], atol=T_TOL, rtol=0, err_msg=f"odom {i}")
        np.testing.assert_allclose(mapped, want[i][3], atol=T_TOL, rtol=0, err_msg=f"mapped {i}")
        np.testing.assert_allclose(odom, port_odom[i], atol=1e-6, rtol=0, err_msg=f"port {i}")
    _quat_close(pipe.sys.o_state.world.quat.numpy(), want[-1][0])
    assert len(pipe.sys.keyframes) == len(js.keyframes) >= 3
    assert [k.frame for k in pipe.sys.keyframes] == [k.frame for k in js.keyframes]
    # Keyframe poses (mapped poses at keyframes) carry the rotations.
    got, ref = pipe.sys.odometry_keyframe_poses(), js.odometry_keyframe_poses()
    np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], atol=T_TOL, rtol=0)
    np.testing.assert_allclose(got[:, :3, :3], ref[:, :3, :3], atol=2 * Q_TOL, rtol=0)
    # the loop thread's drain pass optimised the graph
    assert pipe.stage_frames["loop_opt"] >= 1
    assert pipe.stage_frames["frontend" if fused else "mapping"] == N_FRAMES


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
def test_async_pipeline_drains_on_finish_and_abort_leaves_numpy(scans, fused):
    pipe = _run_async(scans[:3], fused, drop_backlog=True)
    assert len(pipe.odom_results) == 3 and pipe.dropped_frames == 0

    pipe = AsyncSlamPipeline(_tcfg(fused), drop_backlog=False, device="cpu")
    pipe.start(precompile=False)
    for i, s in enumerate(scans[:3]):
        pipe.feed(0.1 * i, s)
    pipe.abort()
    assert pipe.workers_alive == 0
    assert len(pipe.odom_results) <= 3
    assert all(isinstance(x, np.ndarray) for _, x in pipe.odom_results + pipe.mapped_results)


def test_worker_failure_is_raised_by_finish(scans):
    pipe = AsyncSlamPipeline(_tcfg(), drop_backlog=False, device="cpu")
    pipe.start(precompile=False)
    pipe.feed(0.0, np.zeros((4, 2), np.float32))  # no z column: the front end raises
    with pytest.raises(RuntimeError, match="worker failed"):
        pipe.finish(timeout=60.0)
    assert pipe.workers_alive == 0


def test_scancontext_detect_dispatch_then_read(port_sync):
    """None while the database is too small, then the device triple, which
    reads as detect_loop_closure_id's answer: keyframe 0 seen again."""
    cfg = dataclasses.replace(_tcfg().scancontext, num_exclude_recent=2)
    ts, _ = port_sync
    cap = 8192
    sc = tscm.SCManager(cfg, "cpu")
    for k in (0, 1, 0):
        cloud = ts.keyframes[k].cloud[:cap]
        xyz = np.zeros((cap, 3), np.float32)
        xyz[: len(cloud)] = cloud
        m = np.zeros(cap, bool)
        m[: len(cloud)] = True
        out = sc.detect_loop_closure_dispatch()
        assert out is None
        sc.make_and_save(torch.from_numpy(xyz), torch.from_numpy(m))
    out = sc.detect_loop_closure_dispatch()
    assert out is not None and all(isinstance(x, torch.Tensor) for x in out)
    idx, yaw, dist = tscm.read_triple(out)
    assert (idx, yaw, dist) == sc.detect_loop_closure_id()
    assert idx == 0 and dist < 1e-5
