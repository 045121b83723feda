"""The port's batched multi-sequence front end (scaloam_tpu_torch.parallel.
multiseq.frame_batch: one torch.func.vmap of features -> odometry ->
mapping over stacked states) and the kernels' vmap rules, on the CPU.

At tests/test_torch_parallel.py's reduced HDL-64 configuration, three
drives through one synthetic world, two frames each:

- the batched step equals the single-sequence path, sequence by sequence,
  bit for bit (one thread, so every reduction sums in one order), with
  vmap's per-sample fallback warning raised as an error; and frame_batch
  refuses a step whose op would make vmap loop over the batch;
- each kernel's custom op under vmap equals a call a problem, bit for bit,
  with an argument left unbatched (expanded by the rule);
- against the JAX reference's multiseq.frame_batch (vmapped, its selection
  kernel in interpret mode as in tests/test_torch_parallel.py): the same
  batch from fresh states, and a batch whose `initialized` flags differ,
  carried across with convert.multiseq_states_from_numpy; odometry and
  mapped poses within 5e-4 (quaternion) / 5e-3 m (translation), the port's
  front-end tolerances (tests/test_torch_frontend.py).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import mapping as tmap, odometry as todo
from scaloam_tpu_torch.ops import features as tfeat, se3, voxel
from scaloam_tpu_torch.ops.kernels import gn_odometry, selection
from scaloam_tpu_torch.parallel import multiseq
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils import synthetic

N_SEQ, N_FRAMES = 3, 2
Q_TOL, T_TOL = 5e-4, 5e-3


def _reduced(cfgmod):
    """tests/test_torch_parallel.py's reduced HDL-64 configuration, built
    from either package's config module."""
    cfg = cfgmod.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(
            cfg.features, use_pallas_selection="on", max_sharp=768,
            max_less_sharp=2048, max_flat=1536, max_less_flat=8192),
        mapping=dataclasses.replace(
            cfg.mapping, cell_size=4.0, grid_xy=32, grid_z=8, corner_cell_cap=32,
            surf_cell_cap=64, max_corner_input=2048, max_surf_input=4096),
        pgo=dataclasses.replace(cfg.pgo, keyframe_cloud_capacity=8192),
    )


@pytest.fixture(scope="module")
def batch():
    """[frame] -> (xyz [N_SEQ, P, 3], mask [N_SEQ, P]) as numpy."""
    cfg = _reduced(tconfig)
    world = synthetic.make_world(seed=8)
    seqs = [synthetic.simulate_trajectory(world, n_frames=N_FRAMES, speed=0.8 + 0.2 * s,
                                          radius=25.0, n_azimuth=256, seed=3 + s)[0]
            for s in range(N_SEQ)]
    frames = []
    for f in range(N_FRAMES):
        scans = [LidarScan.from_numpy(seqs[s][f], cfg.sensor.max_points, "cpu")
                 for s in range(N_SEQ)]
        frames.append((torch.stack([s.xyz for s in scans]).numpy(),
                       torch.stack([s.mask for s in scans]).numpy()))
    return frames


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qt(p):
    return torch.cat([p.quat, p.trans], dim=-1)


def _run_batched(cfg, frames, states=None):
    """frame_batch over every frame: (states, odometry [F, B, 7], mapped
    [F, B, 7])."""
    o, m = states if states is not None else multiseq.init_states(N_SEQ, cfg, "cpu")
    odom, mapped = [], []
    for xyz, mask in frames:
        o, m, op, mp = multiseq.frame_batch(o, m, torch.from_numpy(xyz),
                                            torch.from_numpy(mask), cfg)
        odom.append(_qt(op))
        mapped.append(_qt(mp))
    return (o, m), torch.stack(odom), torch.stack(mapped)


def test_frame_batch_equals_one_sequence_at_a_time(batch, one_thread):
    """Bit for bit, and no per-sample fallback anywhere in the step."""
    cfg = _reduced(tconfig)
    want_o, want_m, want_clouds = [], [], []
    for s in range(N_SEQ):
        o, m = todo.init_state(cfg, "cpu"), tmap.init_state(cfg, "cpu")
        for xyz, mask in batch:
            feats = tfeat.extract_features(
                LidarScan(torch.from_numpy(xyz[s]), torch.from_numpy(mask[s])), cfg)
            o, o_out = todo.odometry_step(o, feats, cfg)
            m, m_out = tmap.mapping_step(m, o_out.world, feats.less_sharp, feats.less_flat, cfg)
            want_o.append(_qt(o_out.world))
            want_m.append(_qt(m_out.pose))
        want_clouds.append((o.last_corner, o.last_surf, m.corner_grid, m.surf_grid))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=multiseq.FALLBACK_WARNING)
        (o, m), odom, mapped = _run_batched(cfg, batch)
    # [sequence, frame] -> [frame, sequence]
    assert torch.equal(odom, torch.stack(want_o).reshape(N_SEQ, N_FRAMES, 7).transpose(0, 1))
    assert torch.equal(mapped, torch.stack(want_m).reshape(N_SEQ, N_FRAMES, 7).transpose(0, 1))
    for s, clouds in enumerate(want_clouds):
        for got, want in zip((o.last_corner, o.last_surf, m.corner_grid, m.surf_grid), clouds):
            for a, b in zip(got, want):
                assert torch.equal(a[s], b)
    assert o.initialized is True and o.frame_idx.tolist() == [N_FRAMES] * N_SEQ
    assert float(mapped[-1, :, 4:].abs().max()) > 0.5  # the drives moved


def test_frame_batch_refuses_the_per_sample_fallback(batch, monkeypatch):
    """An op with no batching rule (an in-place scatter_ in mapping's
    candidate re-rank) makes vmap loop over the batch: frame_batch raises
    rather than hide that loop."""
    real = voxel.argmin_topk

    def in_place(d, k, payload=None):
        d = d.clone()
        d.scatter_(1, torch.argmin(d, dim=1, keepdim=True), voxel.BIG)
        return real(d, k, payload)

    monkeypatch.setattr(voxel, "argmin_topk", in_place)
    cfg = _reduced(tconfig)
    xyz, mask = batch[0]
    o, m = multiseq.init_states(N_SEQ, cfg, "cpu")
    with pytest.raises(UserWarning, match=multiseq.FALLBACK_WARNING):
        multiseq.frame_batch(o, m, torch.from_numpy(xyz), torch.from_numpy(mask), cfg)


def test_init_states_stack_independent_rows():
    """Every tensor of the fresh states has the leading sequence axis and
    its own storage (a row written does not show in another)."""
    cfg = _reduced(tconfig)
    o, m = multiseq.init_states(N_SEQ, cfg, "cpu")
    assert o.initialized is False and multiseq.num_sequences(o) == N_SEQ
    one_o, one_m = todo.init_state(cfg, "cpu"), tmap.init_state(cfg, "cpu")
    leaves = lambda t: [x for x in torch.utils._pytree.tree_leaves(t)
                        if isinstance(x, torch.Tensor)]
    for got, want in zip(leaves((o, m)), leaves((one_o, one_m))):
        assert got.shape == (N_SEQ, *want.shape) and torch.equal(got[1], want)
    m.corner_grid.pts[0].fill_(7.0)
    assert not torch.equal(m.corner_grid.pts[1], m.corner_grid.pts[0])


def _k1_problem(seed):
    rng = np.random.default_rng(seed)
    S, W, n_sub = 8, 96, 3
    L = rng.integers(W // 2, W - 10, size=S)
    j = np.arange(n_sub)
    return (torch.tensor(rng.integers(0, 8, (S, W)) * 0.05, dtype=torch.float32),
            torch.tensor(rng.integers(0, 4, (S, W)), dtype=torch.int32),
            torch.tensor(rng.integers(0, 4, (S, W)), dtype=torch.int32),
            torch.tensor(rng.uniform(size=(S, W)) < 0.9),
            torch.tensor(5 + (L[:, None] * j) // n_sub, dtype=torch.int32),
            torch.tensor(5 + (L[:, None] * (j + 1)) // n_sub - 1, dtype=torch.int32))


def _k2a_problem(seed, n_c=48, n_s=96):
    rng = np.random.default_rng(seed)
    T = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)
    gt = Pose(se3.exp_so3(T(rng.normal(0, 0.02, 3))), T(rng.normal(0, 0.3, 3)))
    cx, sx = T(rng.uniform(-20, 20, (n_c, 3))), T(rng.uniform(-20, 20, (n_s, 3)))
    cw, sw = se3.apply(gt, cx), se3.apply(gt, sx)
    cand = lambda base, s: base[:, None] + T(rng.normal(0, s, (base.shape[0], 2, 3)))
    return (cx, cand(cw, 0.05), cand(cw, 0.3), T(rng.uniform(size=n_c) < 0.8, torch.bool),
            sx, cand(sw, 0.05), cand(sw, 0.2), cand(sw, 0.3),
            T(rng.uniform(size=n_s) < 0.8, torch.bool),
            T([1.0, 0.0, 0.0, 0.0]), T(rng.normal(0, 0.2, 3)))


def _k2b_problem(seed, n_c=64, n_s=128):
    rng = np.random.default_rng(seed)
    T = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)
    p = T(rng.uniform(-20, 20, (n_c, 3)))
    u = torch.nn.functional.normalize(T(rng.normal(size=(n_c, 3))), dim=1)
    sp = T(rng.uniform(-20, 20, (n_s, 3)))
    n = torch.nn.functional.normalize(T(rng.normal(size=(n_s, 3))), dim=1)
    return (T([1.0, 0.0, 0.0, 0.0]), T(rng.normal(0, 0.2, 3)), p, p + 0.1 * u, p - 0.1 * u,
            T(rng.uniform(size=n_c) < 0.8, torch.bool), sp, n,
            -(n * sp).sum(1) + T(rng.normal(0, 0.01, n_s)),
            T(rng.uniform(size=n_s) < 0.8, torch.bool))


K1_KW = dict(n_sub=3, n_corner=4, n_flat=2, curv_thr=0.1)
K2A_KW = dict(outer_iterations=2, gn_iterations=4, thr=25.0, huber_delta=0.1)
K2B_KW = dict(gn_iterations=4, huber_delta=0.1)
OPS = {
    # name: (public function, one problem's inputs, kwargs, the argument left unbatched)
    "K1": (selection.select_features, _k1_problem, K1_KW, 3),
    "K2 A": (gn_odometry.associate_and_solve, _k2a_problem, K2A_KW, 9),
    "K2 B": (gn_odometry.gn_solve_prepared, _k2b_problem, K2B_KW, 0),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_kernel_op_vmapped_equals_a_call_a_problem(name):
    """Three problems through the custom op's vmap rule, one argument
    shared by all (in_dim None), equal bit for bit to a call a problem."""
    fn, make, kw, shared = OPS[name]
    problems = [make(seed) for seed in (0, 1, 2)]
    args = [torch.stack(a) for a in zip(*problems)]
    args[shared] = problems[0][shared]
    in_dims = tuple(None if i == shared else 0 for i in range(len(args)))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=multiseq.FALLBACK_WARNING)
        got = torch.func.vmap(lambda *a: fn(*a, **kw), in_dims=in_dims)(*args)
    for b, prob in enumerate(problems):
        prob = list(prob)
        prob[shared] = problems[0][shared]
        want = fn(*prob, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), (name, b)


# ---------------------------------------------------------------------------
# against the JAX reference's multiseq.frame_batch
# ---------------------------------------------------------------------------


def _pose_close(got, want):
    """Largest |dq| (sign aligned) and |dt| of [..., 7] poses got (torch)
    against want (numpy quat, trans)."""
    wq, wt = want
    q, t = got[..., :4].numpy(), got[..., 4:].numpy()
    q = q * np.sign(np.sum(q * wq, axis=-1, keepdims=True))
    return float(np.abs(q - wq).max()), float(np.abs(t - wt).max())


@pytest.fixture(scope="module")
def reference(batch):
    """The JAX multiseq over the batch: poses of each frame from fresh
    states, and of the last frame from a state whose middle sequence is
    reset to a fresh one (initialized False beside True). Its selection
    kernel runs in interpret mode."""
    from scaloam_tpu import config as jconfig
    from scaloam_tpu.ops.pallas import selection as jsel
    from scaloam_tpu.parallel import multiseq as jmultiseq

    cfg = _reduced(jconfig)
    orig = jsel.select_features

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jsel.select_features = interp
    try:
        o, m = jmultiseq.init_states(N_SEQ, cfg)
        fresh = jax.tree.map(np.asarray, (o, m))
        poses, after_first = [], None
        for f, (xyz, mask) in enumerate(batch):
            o, m, op, mp = jmultiseq.frame_batch(o, m, xyz, mask, cfg)
            poses.append(((np.asarray(op.quat), np.asarray(op.trans)),
                          (np.asarray(mp.quat), np.asarray(mp.trans))))
            if f == 0:
                after_first = jax.tree.map(np.asarray, (o, m))
        # sequence 1 starts over at the last frame; 0 and 2 go on
        mixed = jax.tree.map(lambda a, b: np.concatenate([a[:1], b[1:2], a[2:]]),
                             after_first, fresh)
        o, m, op, mp = jmultiseq.frame_batch(*mixed, *batch[-1], cfg)
        mixed_poses = ((np.asarray(op.quat), np.asarray(op.trans)),
                       (np.asarray(mp.quat), np.asarray(mp.trans)))
    finally:
        jsel.select_features = orig
    return {"poses": poses, "mixed_state": mixed, "mixed_poses": mixed_poses}


def test_frame_batch_matches_reference_multiseq(batch, reference):
    cfg = _reduced(tconfig)
    _, odom, mapped = _run_batched(cfg, batch)
    for f, (want_o, want_m) in enumerate(reference["poses"]):
        for got, want in ((odom[f], want_o), (mapped[f], want_m)):
            dq, dt = _pose_close(got, want)
            assert dq <= Q_TOL and dt <= T_TOL, (f, dq, dt)
    assert float(mapped[-1, :, 4:].abs().max()) > 0.5


def test_mixed_initialized_flags_match_reference(batch, reference):
    """A batch whose flags differ runs the solve for all and selects the
    identity where not initialized, as the reference's vmapped cond does."""
    cfg = _reduced(tconfig)
    o_tree, m_tree = reference["mixed_state"]
    o, m = convert.multiseq_states_from_numpy(o_tree, m_tree, "cpu")
    assert o.initialized.tolist() == [True, False, True]
    o, m, odom, mapped = multiseq.frame_batch(o, m, *map(torch.from_numpy, batch[-1]), cfg)
    for got, want in ((_qt(odom), reference["mixed_poses"][0]),
                      (_qt(mapped), reference["mixed_poses"][1])):
        dq, dt = _pose_close(got, want)
        assert dq <= Q_TOL and dt <= T_TOL, (dq, dt)
    # the reset sequence's first frame: identity odometry, no correspondences counted
    assert torch.equal(odom.trans[1], torch.zeros(3)) and o.initialized is True
    assert o.degenerate_count.tolist()[1] == 0


def test_multiseq_states_from_numpy_keeps_a_host_flag_where_flags_agree(reference):
    o_tree, m_tree = reference["mixed_state"]
    agree = o_tree._replace(initialized=np.ones(N_SEQ, bool))
    o, m = convert.multiseq_states_from_numpy(agree, m_tree, "cpu")
    assert o.initialized is True
    assert o.last_corner.xyz.shape[0] == N_SEQ and m.corner_grid.pts.shape[0] == N_SEQ
    np.testing.assert_array_equal(m.surf_grid.count.numpy(), m_tree.surf_grid.count)
