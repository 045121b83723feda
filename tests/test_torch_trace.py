"""The port's spans and counters (scaloam_tpu_torch/utils/timing.py,
utils/metrics.py) on the CPU.

- Off (no profiler session): a span records nothing, opens no profiler
  range, makes no CUDA event and moves no counter.
- On (under torch.profiler): spans record their name, parent, request,
  host time, start on the profiler's clock and counts, and lie on the
  profiler's timeline as `slam.<name>` operator ranges; a new session
  clears the last.
- The compile boundary: the bytes a replay moves (`compiled.boundary_bytes`,
  against Σ nbytes), and a replay's spans and counts with the CUDA graph
  replaced by a stand-in that re-runs the captured function.
- The front end: one gate read and one upload a scan; the backend's
  always-on counters; StageTimer's wait for the card.

The card's cases (a captured step's replay, FrontEnd on the card) are in
tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from scaloam_tpu_torch import compiled, config as tconfig
from scaloam_tpu_torch.models import frontend, pipeline
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils import synthetic, timing
from scaloam_tpu_torch.utils.metrics import GLOBAL
from torch_threads import two_threads  # noqa: F401

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profiled():
    return torch.profiler.profile(activities=CPU)


def _off_site():
    """A span site run while tracing is off (ends the last session)."""
    with timing.span("off"):
        pass


def test_a_span_does_nothing_while_tracing_is_off(monkeypatch):
    _off_site()
    with _profiled():
        with timing.span("kept"):
            pass
    ranges, events = [], []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a: ranges.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: events.append(a))
    before = GLOBAL.snapshot()
    assert not torch.autograd._profiler_enabled()
    with timing.span("frontend.step", scans=1, device=True) as s:
        s.add("compiled.host_reads", 1)
        with timing.span("inner", device=True) as t:
            t.add("scan.upload_bytes", 100)
    assert ranges == [] and events == []
    assert GLOBAL.snapshot() == before
    assert [r.name for r in timing.records()] == ["kept"]


def test_spans_record_name_parent_request_and_counts_on_the_profilers_clock():
    _off_site()
    with _profiled() as prof:
        assert torch.autograd._profiler_enabled()
        with timing.span("outer", scans=3) as a:
            a.add("scan.upload_bytes", 10)
            with timing.span("inner") as b:
                b.add("scan.upload_bytes", 5)
                b.add("scan.upload_bytes", 1)
        with timing.span("next"):
            pass
    recs = {r.name: r for r in timing.records()}
    assert [r.name for r in timing.records()] == ["inner", "outer", "next"]
    outer, inner, nxt = recs["outer"], recs["inner"], recs["next"]
    assert outer.parent is None and inner.parent == outer.id and nxt.parent is None
    assert inner.request == outer.request == outer.id and nxt.request == nxt.id != outer.id
    assert outer.counts == {"scans": 3, "scan.upload_bytes": 10}
    assert inner.counts == {"scan.upload_bytes": 6}
    assert all(r.device_ms is None and r.host_ns > 0 for r in recs.values())
    assert outer.host_ns >= inner.host_ns
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("slam.")}
    assert set(kineto) == {"slam.outer", "slam.inner", "slam.next"}
    for name, r in recs.items():
        e = kineto["slam." + name]
        assert not e.is_user_annotation()  # an operator range: not mirrored onto a device
        assert abs(e.start_ns() - r.start_ns) < 5e6  # the same clock (ns)
        assert e.start_ns() <= r.start_ns + 1e6


def test_a_new_session_clears_the_last():
    _off_site()
    with _profiled():
        with timing.span("first"):
            pass
    _off_site()
    with _profiled():
        with timing.span("second"):
            pass
        with timing.span("third"):
            pass
    assert [r.name for r in timing.records()] == ["second", "third"]


def test_counters_move_only_while_tracing():
    name = "test.trace_counter"
    before = GLOBAL.get(name)
    with timing.span("x") as s:
        s.add(name, 7)
    assert GLOBAL.get(name) == before
    with _profiled():
        with timing.span("x") as s:
            s.add(name, 7)
    assert GLOBAL.get(name) == before + 7


def test_profile_trace_turns_spans_on(tmp_path):
    _off_site()
    with timing.profile_trace(str(tmp_path)):
        with timing.span("operator"):
            torch.ones(4).sum()
    assert [r.name for r in timing.records()] == ["operator"]
    assert list(tmp_path.iterdir())  # the trace file


# ---------------------------------------------------------------------------
# the compile boundary
# ---------------------------------------------------------------------------


def test_boundary_bytes_are_the_leaves_nbytes():
    a = torch.zeros((5, 3))  # 60 B
    b = torch.zeros(7, dtype=torch.int64)  # 56 B
    c = torch.zeros(4, dtype=torch.bool)  # 4 B
    shared = torch.zeros(6, dtype=torch.int16)  # 12 B, passed twice
    leaves = [a, True, b, c, shared, shared]
    assert compiled.boundary_bytes(leaves, {}, []) == (60 + 56 + 4 + 12 + 12, 0, 0)
    # outputs: a's new value, b's, a fresh [2, 2] float, a host int, both
    # shared leaves' new values
    outs = [torch.ones((5, 3)), torch.ones(7, dtype=torch.int64), torch.ones((2, 2)), 3,
            torch.ones(6, dtype=torch.int16), torch.ones(6, dtype=torch.int16)]
    donated = {0: 0, 1: 2, 4: 4, 5: 5}
    copy_in, write_back, clone = compiled.boundary_bytes(leaves, donated, outs)
    assert copy_in == 144
    assert write_back == 60 + 56  # a and b written back in place
    assert clone == 16 + 12 + 12  # the fresh output, and the shared pair cloned apart


@compiled.jit(donate_argnums=(0,))
def _toy_step(state, x):
    """A step with a donated state of two leaves and one fresh output."""
    pos, count = state
    return (pos + x, count + 1), (pos * 2.0).sum(dim=-1)


class _Replayer:
    """A CUDA graph's stand-in on the CPU: replay() re-runs the captured
    function and writes its results into the capture's outputs."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        out = self.run()
        for dst, src in zip(pytree.tree_leaves(self.out), pytree.tree_leaves(out)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


class _Stub:
    def wait_event(self, event):
        pass

    def record(self, stream=None):
        pass

    def query(self):
        return True


def _capture(pool, run):
    out = run()
    return _Replayer(run, out), out


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(compiled, "_on_card", lambda tensors, name: True)
    monkeypatch.setattr(compiled, "_capture", _capture)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stub())
    monkeypatch.setattr(torch.cuda, "Event", _Stub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stub())
    monkeypatch.setattr(_toy_step, "_cache", {})


def test_a_replay_records_the_bytes_its_boundary_moves(stand_in_graphs):
    state = (torch.zeros((64, 3)), torch.zeros((), dtype=torch.int32))
    x = torch.ones((64, 3))
    _off_site()
    with _profiled():
        state, _ = _toy_step(state, x)  # the key's first call: eager, then captured
    names = [r.name for r in timing.records()]
    assert names == ["compiled.key", "compiled.capture:test_torch_trace._toy_step"]
    counters = ("compiled.copy_in_bytes", "compiled.keep_bytes", "compiled.write_back_bytes",
                "compiled.clone_bytes")
    before = {c: GLOBAL.get(c) for c in counters}
    _off_site()
    with _profiled():
        state, y = _toy_step(state, x)
    recs = timing.records()
    assert [r.name for r in recs] == ["compiled.key", "compiled.copy_in", "compiled.launch",
                                      "compiled.outputs",
                                      "compiled.replay:test_torch_trace._toy_step"]
    key, copy_in, launch, outputs, replay = recs
    assert key.counts == {"compiled.leaves": 3} and key.parent is None
    assert {copy_in.parent, launch.parent, outputs.parent} == {replay.id}
    state_bytes = 64 * 3 * 4 + 4
    assert copy_in.counts == {"compiled.copy_in_bytes": state_bytes + 64 * 3 * 4}
    assert launch.counts == {"compiled.keep_bytes": state_bytes}  # new state into the buffers
    assert outputs.counts == {"compiled.write_back_bytes": state_bytes,
                              "compiled.clone_bytes": 64 * 4}
    moved = {c: GLOBAL.get(c) - before[c] for c in counters}
    assert moved == {"compiled.copy_in_bytes": state_bytes + 768, "compiled.keep_bytes": 772,
                     "compiled.write_back_bytes": 772, "compiled.clone_bytes": 256}
    assert torch.equal(state[0], 2 * x) and int(state[1]) == 2
    assert torch.equal(y, torch.full((64,), 6.0))


# ---------------------------------------------------------------------------
# the front end and the backend
# ---------------------------------------------------------------------------


def _small_config():
    cfg = tconfig.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=8192, max_points_per_ring=256),
        features=dataclasses.replace(cfg.features, max_sharp=256, max_less_sharp=1024,
                                     max_flat=512, max_less_flat=4096),
        mapping=dataclasses.replace(cfg.mapping, cell_size=4.0, grid_xy=16, grid_z=8,
                                    corner_cell_cap=16, surf_cell_cap=32,
                                    max_corner_input=1024, max_surf_input=2048),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=4096),
    )


def test_a_frontend_step_reads_the_gate_once_and_uploads_its_scan():
    cfg = _small_config()
    world = synthetic.make_world(seed=0, n_boxes=30, extent=40.0)
    scans, _ = synthetic.simulate_trajectory(world, n_frames=2, speed=1.0, radius=20.0,
                                             n_azimuth=128, n_scans=cfg.sensor.n_scans,
                                             lidar_type=cfg.sensor.lidar_type)
    fe = frontend.FrontEnd(cfg, device="cpu")
    reads = GLOBAL.get("compiled.host_reads")
    _off_site()
    with _profiled():
        for points in scans:
            scan = LidarScan.from_numpy(np.asarray(points), cfg.sensor.max_points, "cpu")
            fe.step(scan.xyz, scan.mask)
    recs = timing.records()
    steps = [r for r in recs if r.name == "frontend.step"]
    reads_ = [r for r in recs if r.name == "frontend.gate_read"]
    uploads = [r for r in recs if r.name == "scan.upload"]
    assert len(steps) == len(reads_) == len(uploads) == 2
    assert all(r.counts == {"scans": 1} and r.device_ms is None for r in steps)
    assert [r.parent for r in reads_] == [r.id for r in steps]
    assert [r.request for r in reads_] == [r.id for r in steps]
    assert all(r.counts == {"compiled.host_reads": 1} for r in reads_)
    assert all(r.counts == {"scan.upload_bytes": cfg.sensor.max_points * 13} for r in uploads)
    assert GLOBAL.get("compiled.host_reads") == reads + 2
    # CPU tensors run the steps eagerly: a key span each, no capture or replay
    assert not any(r.name.startswith(("compiled.replay", "compiled.capture")) for r in recs)


def test_the_backend_counts_keyframes_and_loops():
    cfg = _small_config()
    sys_ = pipeline.SlamSystem(cfg, device="cpu")
    n = cfg.pgo.keyframe_cloud_capacity
    before = {k: GLOBAL.get(k) for k in ("keyframes", "loops.proposed", "loops.accepted")}
    for k in range(2):
        sys_._add_keyframe_prepared(torch.zeros((n, 3)), torch.zeros(n, dtype=torch.bool),
                                    torch.zeros((n, 1)), Pose.identity("cpu"), 0.1 * k)
    sys_.sc.detect_loop_closure_id = lambda: (0, 0.0, 0.1)
    sys_._icp_verify = lambda curr, idx, yaw, poses=None: None  # ICP rejects it
    _off_site()
    with _profiled():
        assert sys_._detect_and_verify_loop() is None
    assert [r.name for r in timing.records()] == ["backend.sc_detect"]
    sys_.commit_loop(1, 0, Pose.identity("cpu"))
    moved = {k: GLOBAL.get(k) - v for k, v in before.items()}
    assert moved == {"keyframes": 2, "loops.proposed": 1, "loops.accepted": 1}


@pytest.mark.parametrize("card", [True, False])
def test_a_stage_ends_once_the_card_has_run_it(monkeypatch, card):
    """A stage waits for each card its work runs on (the front end's and
    the backend's), once each, and for nothing on the CPU."""
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: waits.append(a))
    devices = ("cuda:0", torch.device("cuda", 1), "cuda:0", "cpu") if card else ("cpu", "cpu")
    timer = timing.StageTimer(budget_ms=1e9, devices=devices)
    with timer.stage("frame"):
        pass
    assert waits == ([(torch.device("cuda", 0),), (torch.device("cuda", 1),)] if card else [])
    assert len(timer.samples["frame"]) == 1 and timer.mean_ms("frame") >= 0.0
