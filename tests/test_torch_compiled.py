"""The port's compile boundary (scaloam_tpu_torch/compiled.py, the
counterpart of the reference's `jax.jit`) on the CPU, at the reduced
HDL-64 sizes of __graft_entry__._small_cfg (map capacities cut as in
tests/test_torch_runtime.py).

- No host read inside a captured program. A TorchDispatchMode that raises
  on the ops that read the device from the host (a scalar read, `nonzero`,
  `masked_select`, `unique`, boolean-mask indexing, `repeat_interleave`
  without `output_size`, host data copied in) runs over every program the
  port captures on the card: the front end's step to the gate (the first
  frame's program and the later frames'), the keyframe prep, the sync
  driver's three stages (odometry on both keys), `gate_step`, `optimize`
  at a chain-CG and a Woodbury tier, `multiseq` at two sequences, and the
  keyframe backend: ICP's `verify_loop`, ScanContext's `make_and_append`
  and `detect_latest`, the graph's `add_keyframe_jit` (also starting a
  sequence) and `add_loop_jit`. The kernels' custom ops (EXEMPT) pass as
  single calls: on the card each is one kernel launch; on the CPU each
  runs its plain version, which the mode does not see into.
- Cache key: with the capture replaced by a counting stub, a new capture
  happens on a new static argument, a new shape or tier and a flipped
  `initialized`, and on nothing else.
- Donation and clones: with the CUDA graph replaced by a stand-in that
  re-runs the captured function into its static outputs at each replay,
  the front end's donated state is updated in place, every other output
  is a fresh tensor, the results equal the eager step's bit for bit,
  donated leaves that share memory come back apart, and a kernel's launch
  counter counts one a replay and nothing at capture.
- Launch counts and memory: a capture tallies its own thread's launches
  only; all keys of one step capture into one graph memory pool, and keys
  of one tensor layout read one set of input buffers, in which the graph
  leaves the donated state (an output passing a donated input through
  still returns the old value).
- Tiers: appends within one capacity tier share one capture and land in
  consecutive slots read on the device; growing a table past its tier
  drops every key that held the old tier's layout.

The CUDA-only cases (replay against `compiled.disabled()` for each
program on the card) are in tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import __graft_entry__
from scaloam_tpu_torch import compiled, config as tconfig
from scaloam_tpu_torch.models import frontend, mapping, odometry, pipeline, posegraph as pg
from scaloam_tpu_torch.models import scancontext as scm
from scaloam_tpu_torch.ops import features, icp
from scaloam_tpu_torch.parallel import multiseq
from scaloam_tpu_torch.types import FeatureCloud, LidarScan, Pose, RangeImage, ScanFeatures
from scaloam_tpu_torch.utils import synthetic


def _config():
    """__graft_entry__._small_cfg with the map and keyframe-cloud
    capacities cut as tests/test_torch_runtime.py cuts them."""
    cfg = tconfig.from_dict(dataclasses.asdict(__graft_entry__._small_cfg()))
    return cfg.replace(
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192),
    )


CFG = _config()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the file's many small ops otherwise wait on
    thread pools that the suite's other workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The kernels' custom ops: one launch each on the card.
EXEMPT = ("scaloam::select_features", "scaloam::associate_and_solve",
          "scaloam::gn_solve_prepared", "scaloam::sq_dist", "scaloam::sum3_sq",
          "scaloam::atan2f", "scaloam::kabsch", "scaloam::segment_sum", "scaloam::hess_matvec",
          "scaloam::kabsch_step", "scaloam::ring_azimuth", "scaloam::chain_solve",
          "scaloam::sweep_top2")
# Ops that read the device from the host whatever their arguments.
HOST_READS = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::nonzero",
              "aten::masked_select", "aten::_unique", "aten::_unique2", "aten::unique_dim",
              "aten::unique_consecutive", "aten::unique_dim_consecutive", "aten::equal",
              "aten::bincount")


class HostReadGuard(TorchDispatchMode):
    """Raises on an op that would make the host wait for the device, or
    copy host memory to it, so that a CUDA graph cannot hold it; records
    the exempt custom ops. A Python scalar written with basic or integer
    indexing (`x[..., 0] = 1.0`) is a host tensor copied in on the card;
    a boolean mask with a scalar (`x[mask] = 0.0`) is a masked fill."""

    def __init__(self):
        super().__init__()
        self.exempt_seen = set()
        self.host_data = set()  # ids of tensors made from host data

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        masked_fill = False
        if name.startswith("scaloam::"):
            if name not in EXEMPT:
                raise AssertionError(f"custom op {name} is not a named exemption")
            self.exempt_seen.add(name)
        elif name in HOST_READS:
            raise AssertionError(f"host read inside a captured program: {name}")
        elif name in ("aten::index", "aten::index_put", "aten::index_put_",
                      "aten::_index_put_impl_"):
            masks = [i for i in args[1] if i is not None and i.dtype in (torch.bool, torch.uint8)]
            # x[mask] = scalar is a masked fill; any other boolean index
            # counts the mask's true entries on the host.
            masked_fill = name != "aten::index" and len(args[1]) == 1 and len(masks) == 1
            if masks and not (masked_fill and args[2].numel() == 1):
                raise AssertionError(f"boolean-mask indexing inside a captured program: {name}")
        elif name == "aten::repeat_interleave" and kwargs.get("output_size") is None:
            raise AssertionError("repeat_interleave without output_size inside a captured program")
        if name in ("aten::copy_", "aten::fill_", "aten::_to_copy", "aten::index_put",
                    "aten::index_put_", "aten::_index_put_impl_") and not masked_fill:
            if any(id(a) in self.host_data for a in args if torch.is_tensor(a)):
                raise AssertionError(f"host data copied in inside a captured program: {name}")
        out = func(*args, **kwargs)
        if name == "aten::lift_fresh":
            if args[0].numel() > 1:
                raise AssertionError("host data copied in inside a captured program")
            self.host_data.add(id(out))
        return out


def _scans(n, seed=3):
    world = synthetic.make_world(seed=8)
    return synthetic.simulate_trajectory(world, n_frames=n, speed=0.8, radius=25.0,
                                         n_azimuth=512, seed=seed)[0]


def _scan(points) -> LidarScan:
    return LidarScan.from_numpy(points, CFG.sensor.max_points, "cpu")


@pytest.fixture(scope="module")
def drive():
    """Two frames of the front end: the programs' inputs at both keys."""
    scans = _scans(2)
    s0 = frontend.init_state(CFG, "cpu")
    s1, _ = frontend.frontend_step(s0, _scan(scans[0]), CFG)
    feats = features.extract_features(_scan(scans[1]), CFG)
    return {"scans": scans, "state0": s0, "state1": s1, "feats": feats}


def _chain(n, n_loops, cfg):
    """A drifted straight chain of n nodes with n_loops loop factors."""
    rng = np.random.default_rng(n)
    g = pg.init_graph(cfg, "cpu", initial_nodes=n, initial_loops=n_loops)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    for k in range(n):
        t = torch.tensor([float(k), 0.05 * k * rng.standard_normal(), 0.0], dtype=torch.float32)
        g = pg.add_keyframe(g, Pose(ident, t), 0.0, False, n_nodes=k)
    for m in range(n_loops):
        i, j = n - 1 - m, m
        z = Pose(ident, torch.tensor([float(j - i), 0.0, 0.0]))
        g = pg.add_loop(g, i, j, z, n_loops=m)
    return g


def _verify_inputs():
    """verify_loop's arguments at small sizes: a submap, a source cloud
    that is part of it moved by a small rotation and shift, both seeds."""
    rng = np.random.default_rng(6)
    tgt = rng.uniform(-12, 12, (2048, 3)).astype(np.float32)
    tgt[:, 2] *= 0.2
    c, s = np.cos(0.1), np.sin(0.1)
    src = (tgt[:512] - [0.5, -0.3, 0.0]) @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    src = torch.from_numpy(src.astype(np.float32))
    tgt, ones = torch.from_numpy(tgt), lambda n: torch.ones(n, dtype=torch.bool)
    inits = Pose(torch.tensor([[1.0, 0, 0, 0], [np.cos(-0.05), 0, 0, np.sin(-0.05)]],
                              dtype=torch.float32), torch.zeros((2, 3)))
    kw = dict(voxel_size=0.4, sub_capacity=2048, gx=16, gy=16, gz=16, cell_size=2.0,
              cell_cap=16, dedup_radius=0.4, reach=2.0, max_corr_dist=150.0,
              coarse_iterations=3, fine_iterations=3, transformation_eps=1e-6)
    return (src, ones(512), src[::4].clone(), ones(128), tgt[::4].clone(), ones(512), tgt,
            ones(2048), inits), kw


def _sc_db(n):
    """A ScanContext database holding n random descriptors."""
    db = scm.init_db(CFG.scancontext, "cpu", initial=16)
    for d in np.random.default_rng(n).uniform(0, 3, (n, CFG.scancontext.num_ring,
                                                     CFG.scancontext.num_sector)):
        db = scm.append_descriptor(db, torch.from_numpy(d.astype(np.float32)))
    return db


def _backend_program(name, drive):
    """The keyframe backend's programs, their inputs made beforehand."""
    full = drive["feats"].full
    if name == "verify_loop":
        args, kw = _verify_inputs()
        return lambda: icp.verify_loop(*args, **kw)
    if name == "sc_make_and_append":
        db = _sc_db(3)
        kf_xyz, kf_mask, _ = pipeline._prepare_keyframe(full.xyz, full.mask, full.rel_time, CFG)
        return lambda: scm.make_and_append(db, kf_xyz, kf_mask, CFG.scancontext)
    if name == "sc_detect_latest":
        db = _sc_db(CFG.scancontext.num_exclude_recent + 4)
        return lambda: scm.detect_latest(db, CFG.scancontext)
    graph = _chain(8, 2, CFG.pgo)
    pose = Pose(torch.tensor([0.0, 0.6, 0.0, 0.8]), torch.tensor([8.0, 0.5, 0.2]))
    if name == "add_loop":
        return lambda: pg.add_loop_jit(graph, torch.tensor(7), torch.tensor(1), pose)
    z, ok = torch.tensor(1.5), torch.tensor(1.0)
    return lambda: pg.add_keyframe_jit(graph, pose, z, ok,
                                       new_sequence=name == "add_keyframe_new_sequence")


def _program(name, drive):
    """The call of one captured program, its inputs made beforehand."""
    s0, s1, feats = drive["state0"], drive["state1"], drive["feats"]
    if name in BACKEND:
        return _backend_program(name, drive)
    scan = _scan(drive["scans"][1])
    full = feats.full
    if name.startswith("optimize"):
        cfg = CFG.pgo if name == "optimize_chain_cg" else dataclasses.replace(
            CFG.pgo, wb_min_nodes=64)
        assert pg.uses_woodbury(64, 4, cfg) == (name == "optimize_woodbury")
        graph = _chain(64, 4, cfg)
        return lambda: pg.optimize(graph, cfg)
    if name == "frame_batch_b2":
        states = multiseq.init_states(2, CFG, "cpu")
        other = _scan(drive["scans"][0])
        xyz, mask = torch.stack([scan.xyz, other.xyz]), torch.stack([scan.mask, other.mask])
        return lambda: multiseq.frame_batch(*states, xyz, mask, CFG)
    return {
        "frontend_body_first": lambda: frontend._step_body(s0, scan, CFG),
        "frontend_body_later": lambda: frontend._step_body(s1, scan, CFG),
        "keyframe_prep": lambda: pipeline._prepare_keyframe(
            full.xyz, full.mask, full.rel_time, CFG),
        "extract_features": lambda: features.extract_features(scan, CFG),
        "odometry_first": lambda: odometry.odometry_step(s0.o, feats, CFG),
        "odometry_later": lambda: odometry.odometry_step(s1.o, feats, CFG),
        "mapping": lambda: mapping.mapping_step(
            s1.m, s1.o.world, feats.less_sharp, feats.less_flat, CFG),
        "gate": lambda: pipeline.gate_step(
            s1.gate, s1.m.pose.quat, s1.m.pose.trans, 0.5, 10.0),
    }[name]


BACKEND = ("verify_loop", "sc_make_and_append", "sc_detect_latest", "add_keyframe",
           "add_keyframe_new_sequence", "add_loop")
PROGRAMS = ("frontend_body_first", "frontend_body_later", "keyframe_prep", "extract_features",
            "odometry_first", "odometry_later", "mapping", "gate", "optimize_chain_cg",
            "optimize_woodbury", "frame_batch_b2") + BACKEND


@pytest.mark.parametrize("name", PROGRAMS)
def test_captured_programs_read_nothing_from_the_device(drive, name):
    call = _program(name, drive)
    guard = HostReadGuard()
    with guard:
        out = call()
    assert all(torch.isfinite(x).all() for x in pytree.tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.is_floating_point())
    if name in ("frontend_body_later", "odometry_later"):
        assert {"scaloam::associate_and_solve", "scaloam::sweep_top2"} <= guard.exempt_seen
    if name == "verify_loop":
        assert "scaloam::kabsch_step" in guard.exempt_seen
    if name.startswith("optimize"):
        assert {"scaloam::segment_sum", "scaloam::hess_matvec",
                "scaloam::chain_solve"} <= guard.exempt_seen
    if name in ("frontend_body_first", "frontend_body_later", "extract_features",
                "frame_batch_b2"):
        assert "scaloam::ring_azimuth" in guard.exempt_seen
    assert guard.exempt_seen <= set(EXEMPT)


def test_the_guard_catches_a_host_read():
    x = torch.arange(4.0)
    for read in (lambda: bool(x.sum() > 1), lambda: x[x > 1], lambda: torch.nonzero(x),
                 lambda: torch.tensor([1.0, 2.0]), lambda: torch.unique(x)):
        with pytest.raises(AssertionError):
            with HostReadGuard():
                read()
    for write in (lambda: x.__setitem__((Ellipsis, 0), 1.0),
                  lambda: x.__setitem__(torch.tensor([0, 1]), 1.0)):
        with pytest.raises(AssertionError):
            with HostReadGuard():
                write()
    with HostReadGuard():
        x[x > 1] = 0.0  # a masked fill reads nothing
        x[1:].fill_(2.0)


# ---------------------------------------------------------------------------
# cache key
# ---------------------------------------------------------------------------


def _features(n):
    cloud = FeatureCloud.empty(n, "cpu")
    ri = RangeImage(torch.zeros((4, 8, 3)), torch.zeros((4, 8), dtype=torch.bool),
                    torch.zeros((4, 8)), torch.zeros(4, dtype=torch.int32))
    return ScanFeatures(cloud, cloud, cloud, cloud, ri, torch.zeros((), dtype=torch.int32))


def test_a_new_capture_only_on_a_new_key(monkeypatch):
    captured = []
    cfg = CFG.pgo
    g16, g16b, g32 = _chain(16, 4, cfg), _chain(16, 4, cfg), _chain(32, 4, cfg)

    def first_call(self, key, arguments, dynamic, per_arg, leaves):
        captured.append(self.__name__)
        self._cache[key] = "entry"

    monkeypatch.setattr(compiled, "_on_card", lambda tensors, name: True)
    monkeypatch.setattr(compiled.Compiled, "_first_call", first_call)
    monkeypatch.setattr(compiled.Compiled, "_replay", lambda self, entry, leaves: None)
    for fn in (pg.optimize, odometry.odometry_step, pipeline.gate_step):
        monkeypatch.setattr(fn, "_cache", {})

    def new_captures(call):
        n = len(captured)
        call()
        return len(captured) - n

    g16b.poses.trans.add_(1.0)
    assert new_captures(lambda: pg.optimize(g16, cfg)) == 1
    assert new_captures(lambda: pg.optimize(g16, cfg)) == 0
    assert new_captures(lambda: pg.optimize(g16b, cfg)) == 0  # other values
    assert new_captures(lambda: pg.optimize(g16, cfg, cg_iters=32)) == 1  # static argument
    assert new_captures(lambda: pg.optimize(g16, dataclasses.replace(cfg, cauchy_k=2.0))) == 1
    assert new_captures(lambda: pg.optimize(g32, cfg)) == 1  # the next tier
    assert new_captures(lambda: pg.optimize(pg.grow(g16, 32), cfg)) == 0  # the same tier

    o = odometry.init_state(CFG, "cpu")
    feats = _features(64)
    assert new_captures(lambda: odometry.odometry_step(o, feats, CFG)) == 1
    assert new_captures(lambda: odometry.odometry_step(o._replace(initialized=True), feats,
                                                       CFG)) == 1
    o2 = o._replace(initialized=True, world=Pose.identity("cpu"))
    o2.world.trans.fill_(3.0)
    assert new_captures(lambda: odometry.odometry_step(o2, feats, CFG)) == 0
    assert new_captures(lambda: odometry.odometry_step(o, _features(128), CFG)) == 1  # shape

    q, t = torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3)
    gs = pipeline.init_gate_state("cpu")
    assert new_captures(lambda: pipeline.gate_step(gs, q, t, 1.0, 10.0)) == 1
    assert new_captures(lambda: pipeline.gate_step(gs, q, t + 1.0, 1.0, 10.0)) == 0
    assert new_captures(lambda: pipeline.gate_step(gs, q, t, 2.0, 10.0)) == 1
    assert captured.count("optimize") == 4 and captured.count("odometry_step") == 3


# ---------------------------------------------------------------------------
# donation and clones
# ---------------------------------------------------------------------------


class _Replayer:
    """A CUDA graph's stand-in on the CPU: replay() runs the captured
    function again over its static inputs and writes the results into the
    outputs the capture returned, as a graph's replay overwrites its
    static outputs."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        with compiled._tallied():  # a graph runs no Python: its wrappers count nothing
            out = self.run()
        for dst, src in zip(pytree.tree_leaves(self.out), pytree.tree_leaves(out)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


class _Stream:
    def wait_event(self, event):
        pass


class _Event:
    def record(self, stream=None):
        pass

    def query(self):
        return True


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """compiled.py on CPU tensors with _Replayer in place of CUDA graphs."""
    def capture(pool, run):
        out = run()
        return _Replayer(run, out), out

    monkeypatch.setattr(compiled, "_on_card", lambda tensors, name: True)
    monkeypatch.setattr(compiled, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(frontend._step_body, "_cache", {})
    monkeypatch.setattr(pipeline._prepare_keyframe, "_cache", {})


def _tensor_ids(tree):
    return [id(x) for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, tree)


def test_donated_state_is_written_in_place_and_outputs_are_fresh(stand_in_graphs, drive):
    """Two frames from the state after the first: the later frames'
    program captured on the first, replayed on the second."""
    scans = [_scan(drive["scans"][1]), _scan(drive["scans"][0])]
    with compiled.disabled():
        state, eager = _clone(drive["state1"]), []
        for scan in scans:
            state, out = frontend.frontend_step(state, scan, CFG)
            eager.append((state, out))
    state, outs = _clone(drive["state1"]), []
    for f, scan in enumerate(scans):
        before = _tensor_ids(state)
        state, out = frontend.frontend_step(state, scan, CFG)
        outs.append(out)
        assert _tensor_ids(state) == before  # written in place
        for a, b in zip(pytree.tree_leaves((state, out)), pytree.tree_leaves(eager[f])):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    static = {x.data_ptr() for e in frontend._step_body._cache.values()
              for x in e.out_leaves + e.static_in if isinstance(x, torch.Tensor)}
    got = [x for x in pytree.tree_leaves(outs) if isinstance(x, torch.Tensor)]
    assert not {x.data_ptr() for x in got} & static
    # The first frame's outputs were not overwritten by the replay.
    for a, b in zip(pytree.tree_leaves(outs[0]), pytree.tree_leaves(eager[0][1])):
        assert torch.equal(a, b)
    assert len(frontend._step_body._cache) == 1


def test_a_replay_counts_its_launches_and_the_capture_none(stand_in_graphs, monkeypatch):
    def kernel(x):
        compiled.count(kernel)
        return x + 1.0

    kernel.launches = 0

    @compiled.jit(donate_argnums=(0,))
    def step(state, x):
        return kernel(kernel(state)), x * 2.0

    state = torch.zeros(3)
    buf = state
    for n in range(1, 4):
        state, y = step(state, torch.full((3,), float(n)))
        assert state is buf and torch.equal(state, torch.full((3,), 2.0 * n))
        assert torch.equal(y, torch.full((3,), 2.0 * n))
        assert kernel.launches == 2 * n  # eager first call, then replays
    assert step.captures == 1
    with compiled.disabled():
        state, _ = step(state, torch.zeros(3))
    assert state is not buf and kernel.launches == 8


def test_a_capture_tallies_only_its_own_threads_launches():
    """While a thread captures, a launch made on another thread counts on
    the counter at once, not in the capture (whose graph adds its tally
    at each replay)."""
    def kernel():
        compiled.count(kernel)

    kernel.launches = 0
    with compiled._tallied() as tally:
        kernel()
        other = threading.Thread(target=kernel)
        other.start()
        other.join()
        kernel()
    assert tally == {kernel: 2} and kernel.launches == 1
    kernel()
    assert kernel.launches == 2


def test_the_keys_of_a_step_share_one_graph_pool(stand_in_graphs, monkeypatch):
    pools = []
    capture = compiled._capture

    def spy(pool, run):
        pools.append(pool)
        return capture(pool, run)

    monkeypatch.setattr(compiled, "_capture", spy)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)

    @compiled.jit()
    def step(x):
        return x * 2.0

    for n in (2, 3, 2, 4):
        assert torch.equal(step(torch.ones(n)), torch.full((n,), 2.0))
    assert len(pools) == 3 and pools[0][0] is not None and pools[0] is pools[1] is pools[2]


def test_keys_of_one_tensor_layout_share_their_input_buffers(stand_in_graphs):
    """A host flag makes a second key over the same tensors: both graphs
    read one set of input buffers, and each replay still computes its
    own branch on the value it was given."""
    @compiled.jit(donate_argnums=(0,))
    def step(state, x, flip):
        return (-state if flip else state + x),

    state = torch.zeros(3)
    for flip, want in ((False, 1.0), (True, -1.0), (False, 0.0), (True, 0.0), (True, 0.0)):
        (state,) = step(state, torch.ones(3), flip)
        assert torch.equal(state, torch.full((3,), want))
    assert step.captures == 2 and len(step._buffers) == 1
    a, b = step._cache.values()
    assert a.static_in is b.static_in


def test_an_output_passing_a_donated_input_through_keeps_its_old_value(stand_in_graphs):
    """The graph leaves the new state in the input buffers; an output that
    is the donated input itself still returns the value the call began
    with."""
    @compiled.jit(donate_argnums=(0,))
    def step(state):
        return state + 1.0, state

    state = torch.zeros(2)
    for n in range(1, 4):
        state, old = step(state)
        assert torch.equal(state, torch.full((2,), float(n)))
        assert torch.equal(old, torch.full((2,), n - 1.0))
    assert step.captures == 1


def test_donated_tensors_sharing_memory_come_back_apart(stand_in_graphs):
    """A donated state whose two leaves are one tensor (as
    odometry.init_state's zero counters are) cannot take both values in
    place: those leaves come back as fresh tensors, apart from then on."""
    @compiled.jit(donate_argnums=(0,))
    def bump(pair):
        return (pair[0] + 1.0, pair[1] + 2.0),

    z = torch.zeros(2)
    (a, b), = bump((z, z))
    assert a is not z and b is not z and a is not b
    assert torch.equal(z, torch.zeros(2))
    assert torch.equal(a, torch.ones(2)) and torch.equal(b, torch.full((2,), 2.0))
    (a2, b2), = bump((a, b))
    assert a2 is a and b2 is b
    assert torch.equal(a, torch.full((2,), 2.0)) and torch.equal(b, torch.full((2,), 4.0))


def test_appends_share_a_capture_per_tier_and_growth_drops_the_tier(stand_in_graphs,
                                                                    monkeypatch):
    """Five keyframes appended through the host wrapper at one tier: one
    capture, slots 0-4 (read on the device at each replay). Growing the
    graph past the tier drops every key that held its layout, in each
    step, while another tier's keys stay."""
    for step in (pg.add_keyframe_jit, pg.optimize):
        for attr, value in (("_cache", {}), ("_buffers", {}), ("_pools", {}), ("_done", {}),
                            ("_retired", []), ("captures", 0)):
            monkeypatch.setattr(step, attr, value)
    cfg = dataclasses.replace(CFG.pgo, max_keyframes=64)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0])
    g = pg.init_graph(cfg, "cpu", initial_nodes=8, initial_loops=4)
    other = _chain(16, 4, cfg)  # a tier that is not outgrown
    pg.optimize(other, cfg)
    assert pg.add_keyframe_jit.captures == 1
    for k in range(5):
        g = pg.add_keyframe(g, Pose(quat, torch.tensor([float(k), 0.0, 0.0])), 0.5 * k, True,
                            n_nodes=k)
    assert pg.add_keyframe_jit.captures == 2 and int(g.n_nodes) == 5
    np.testing.assert_array_equal(g.poses.trans[:, 0].numpy(), [0, 1, 2, 3, 4, 0, 0, 0])
    np.testing.assert_array_equal(g.gps_z.numpy(), [0, 0.5, 1, 1.5, 2, 0, 0, 0])
    assert g.gps_valid[:5].all() and not g.gps_valid[5:].any()
    pg.optimize(g, cfg)
    assert len(pg.optimize._cache) == 2
    old = compiled._leaf_key(g.gps_z)
    for k in range(5, 9):  # the ninth node grows the graph to 16 nodes
        g = pg.add_keyframe(g, Pose(quat, torch.tensor([float(k), 0.0, 0.0])), 0.0, False,
                            n_nodes=k)
    assert pg.node_capacity(g) == 16 and int(g.n_nodes) == 9
    np.testing.assert_array_equal(g.poses.trans[:9, 0].numpy(), np.arange(9))
    for step in (pg.add_keyframe_jit, pg.optimize):
        assert not any(old in key[2] for key in step._cache)
        assert not any(old in layout for layout in step._buffers)
        assert not step._retired  # the stand-in's replays have all run
    # The 16-node tier's keys (`other`'s) stay, and serve the grown graph.
    assert pg.add_keyframe_jit.captures == 2 and len(pg.add_keyframe_jit._cache) == 1
    assert len(pg.optimize._cache) == 1
