"""The port's multi-device layer (scaloam_tpu_torch.parallel) against the
JAX reference's (scaloam_tpu.parallel), and the backend device, on the CPU.

The port's side runs as W ranks: this file run as a script (the
`__main__` block at the end), one process a rank, over gloo with a
`file://` store in the test's temporary directory. The ranks import torch,
numpy and the port, never JAX or conftest.py. The JAX side runs in the test
process on scaloam_tpu.parallel.mesh.make_mesh(W), the first W of
conftest's 8 virtual CPU devices: the same shard count and layout. Every
input is made from a numpy seed and fed to both. Each world is started
once for the whole file and runs while the JAX side computes.

- W = 4: detect_loop_sharded (index and yaw exact, distance within 1e-6),
  knn_grid_sharded (atol 1e-5 / rtol 3e-7, neighbours equal within reach:
  tests/test_parallel_gridmap.py's bounds), optimize_sharded (30 nodes,
  one perturbed loop, GPS every third node: within 5e-3 m and
  |q.q'| >= 1 - 1e-4, tests/test_parallel.py's bounds), and the
  (seq 2, kf 2) dry run with finite poses.
- W = 2: multiseq.frame_batch (one vmapped step over the stacked states,
  sharded a sequence a rank) over 2 sequences x 2 frames at a reduced
  HDL-64 configuration, equal to the port's own one-sequence-at-a-time run
  and within 5e-4 / 5e-3 m of the reference's sequential stages (its
  selection kernel in interpret mode, as in tests/test_torch_frontend.py).
- distributed.initialize: a no-op without a launcher's environment; a
  request it cannot meet raises (in a subprocess).
- The backend device on the CPU (3 frames): SlamSystem, its resume and
  AsyncSlamPipeline with backend_device="cpu" equal the single-device
  runs; run.py --backend-device N exits 2 without that card.
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from scaloam_tpu_torch import config as tconfig, run as trun
from scaloam_tpu_torch.config import PGOConfig, ScanContextConfig
from scaloam_tpu_torch.models import mapping as tmap, odometry as todo
from scaloam_tpu_torch.models import pipeline as tpipe, posegraph as tpg
from scaloam_tpu_torch.ops import features as tfeat, gridmap as tgm
from scaloam_tpu_torch.parallel import distributed, dryrun, multiseq
from scaloam_tpu_torch.parallel import gridmap as pgrid, mesh as tmesh, pgo as tpgo
from scaloam_tpu_torch.parallel import sc_retrieval as tsc
from scaloam_tpu_torch.runtime.pipeline import AsyncSlamPipeline
from scaloam_tpu_torch.types import LidarScan, Pose
from scaloam_tpu_torch.utils import synthetic
from torch_threads import two_threads  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300  # a world that does not finish in time fails its tests
Q_TOL, T_TOL = 5e-4, 5e-3
# Variables by which a launcher announces a multi-process run; the ranks
# and subprocesses here run without them.
LAUNCHER_VARS = ("TORCHELASTIC_RUN_ID", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NTASKS",
                 "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")

# ---------------------------------------------------------------------------
# inputs, the same numbers on both sides
# ---------------------------------------------------------------------------

SC_CFG = dict(num_exclude_recent=4, num_candidates=3, max_keyframes=64, dist_threshold=0.5)
GX = GY = 16
GZ = 8
CS = 4.0
# A loop weighted like the odometry (not the preset's 0.5 variance), so the
# perturbed loop moves the chain by far more than the tolerance.
PGO_CFG = dict(max_keyframes=64, max_loops=8, gn_iterations=5, loop_variance=1e-4,
               cauchy_k=100.0)
PGO_NODES = 30


def _sc_inputs():
    """tests/test_parallel.py's database: 40 structured descriptors in 64
    slots, their ring keys (numpy, so both sides rank the same keys) and a
    query resembling keyframe 7."""
    rng = np.random.default_rng(0)
    desc = np.zeros((64, 20, 60), np.float32)
    for k in range(40):
        base = np.zeros((20, 60))
        base[:, (3 * k) % 60] = 5.0 + k * 0.1
        desc[k] = base + rng.uniform(0, 0.5, size=(20, 60))
    q = np.zeros((20, 60))
    q[:, 21] = 5.7
    query = (q + rng.uniform(0, 0.3, size=(20, 60))).astype(np.float32)
    return desc, desc.mean(axis=-1), 40, query


def _grid_inputs():
    """A [GX*GY*GZ, 16] cell grid holding 4096 points of a 24 m cube, each
    in its cell's next slot while the cell has room, filled in numpy; 256
    queries inside it, every fourth masked off."""
    rng = np.random.default_rng(1)
    C, K = GX * GY * GZ, 16
    pts = np.full((C, K, 3), 1e9, np.float32)
    count = np.zeros(C, np.int32)
    coord = np.full((C, 3), 2**30, np.int32)
    for p in rng.uniform(-12, 12, size=(4096, 3)).astype(np.float32):
        cc = np.floor(p / CS).astype(np.int32)
        idx = (cc[0] % GX) * GY * GZ + (cc[1] % GY) * GZ + cc[2] % GZ
        if count[idx] < K:
            pts[idx, count[idx]] = p
            count[idx] += 1
            coord[idx] = cc
    query = rng.uniform(-10, 10, size=(256, 3)).astype(np.float32)
    return pts, count, coord, query, np.arange(256) % 4 != 3


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _rotate(q, v):
    return _quat_mul(_quat_mul(q, np.concatenate([[0.0], v])), q * [1, -1, -1, -1])[1:]


def _pgo_inputs():
    """tests/test_parallel.py's chain in float64 numpy: PGO_NODES poses,
    GPS altitude 0.1 valid on every third node, and the loop (last -> first)
    with its measurement perturbed by 0.3 m on each axis."""
    rng = np.random.default_rng(2)
    q, t = np.array([1.0, 0, 0, 0]), np.zeros(3)
    quats, trans = [], []
    for _ in range(PGO_NODES):
        w = rng.normal(0, 0.05, 3)
        th = np.linalg.norm(w)
        dq = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * w / max(th, 1e-12)])
        q = _quat_mul(q, dq)
        q /= np.linalg.norm(q)
        t = t + rng.normal(0, 0.5, 3)
        quats.append(q)
        trans.append(t)
    qi_inv = quats[-1] * [1, -1, -1, -1]
    zq = _quat_mul(qi_inv, quats[0])
    zt = _rotate(qi_inv, trans[0] - trans[-1]) + 0.3
    return (np.asarray(quats, np.float32), np.asarray(trans, np.float32),
            zq.astype(np.float32), zt.astype(np.float32))


def _port_graph(device="cpu"):
    quats, trans, zq, zt = _pgo_inputs()
    g = tpg.init_graph(PGOConfig(**PGO_CFG), device)
    for k in range(PGO_NODES):
        g = tpg.add_keyframe(g, Pose(torch.from_numpy(quats[k]), torch.from_numpy(trans[k])),
                             0.1, k % 3 == 0, n_nodes=k)
    return tpg.add_loop(g, PGO_NODES - 1, 0, Pose(torch.from_numpy(zq), torch.from_numpy(zt)),
                        n_loops=0)


def _reduced(cfgmod):
    """tests/test_torch_frontend.py's reduced HDL-64 configuration, built
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


N_SEQ, N_FRAMES = 2, 2


def _seq_scans():
    """[sequence][frame] scans: two drives through one synthetic world."""
    world = synthetic.make_world(seed=8)
    return [synthetic.simulate_trajectory(world, n_frames=N_FRAMES, speed=0.8 + 0.2 * s,
                                          radius=25.0, n_azimuth=256, seed=3 + s)[0]
            for s in range(N_SEQ)]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_world4(mesh):
    """Each sharded function on the 1-D mesh of 4 (the pose graph also
    single-device), then the 2-D dry run."""
    desc, keys, count, query = _sc_inputs()
    sc_cfg = ScanContextConfig(**SC_CFG)
    loop = tsc.detect_loop_sharded(
        mesh, torch.from_numpy(query), tmesh.shard_rows(mesh, torch.from_numpy(desc)),
        tmesh.shard_rows(mesh, torch.from_numpy(keys)), torch.tensor(count), sc_cfg)
    pts, cnt, coord, q, qm = (torch.from_numpy(a) for a in _grid_inputs())
    grid = tgm.GridMap(pts, cnt, coord, torch.sum(cnt).to(torch.int32))
    d, nn = pgrid.knn_grid_sharded(mesh, pgrid.shard_grid(mesh, grid), q, qm,
                                   GX, GY, GZ, CS, reach=1.0, k=5)
    g = tpgo.optimize_sharded(_port_graph(), PGOConfig(**PGO_CFG), mesh, cg_iters=48)
    single = tpg.optimize(_port_graph(), PGOConfig(**PGO_CFG), cg_iters=48)  # chain-CG at 64
    dry = dryrun.dryrun("cpu", cfg=_reduced(tconfig))
    return {"loop": torch.stack([x.to(torch.float64) for x in loop]), "knn_d": d, "knn_nn": nn,
            "pgo_q": g.poses.quat, "pgo_t": g.poses.trans, "single_t": single.poses.trans,
            "dry_layout": dry["layout"],
            "dry_mapped": dry["mapped"].trans, "dry_graph": dry["graph_poses"].trans,
            "dry_loop": torch.stack([x.to(torch.float64) for x in dry["loop"]])}


def _mesh_refusals() -> int:
    """ValueErrors of meshes a world of 2 cannot hold: more ranks, no room
    for the kf axis, ranks left off the mesh, a 2x2 mesh."""
    refused = 0
    for call in (lambda: tmesh.make_mesh(3, "cpu"), lambda: tmesh.make_mesh2d(3, None, "cpu"),
                 lambda: tmesh.make_mesh2d(1, 1, "cpu"), lambda: tmesh.make_mesh2d(2, 2, "cpu")):
        try:
            call()
        except ValueError:
            refused += 1
    return refused


def _rank_world2(mesh):
    """multiseq over the 1-D mesh of 2: one sequence a rank."""
    cfg = _reduced(tconfig)
    scans = _seq_scans()
    o_states, m_states = multiseq.shard_states(multiseq.init_states(N_SEQ, cfg, "cpu"), mesh)
    odom, mapped = [], []
    for f in range(N_FRAMES):
        batch = [LidarScan.from_numpy(scans[s][f], cfg.sensor.max_points, "cpu")
                 for s in range(N_SEQ)]
        o_states, m_states, o_pose, m_pose = multiseq.frame_batch(
            o_states, m_states, torch.stack([b.xyz for b in batch]),
            torch.stack([b.mask for b in batch]), cfg, mesh=mesh)
        for out, p in ((odom, o_pose), (mapped, m_pose)):
            p = multiseq.gather_poses(p, mesh)
            out.append(torch.cat([p.quat, p.trans], dim=-1))
    return {"odom": torch.stack(odom), "mapped": torch.stack(mapped),
            "local": multiseq.num_sequences(o_states), "refused": _mesh_refusals()}


def _rank_main(world: int, rank: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", timeout=120)
    mesh = distributed.global_mesh("cpu")
    out = (_rank_world4 if world == 4 else _rank_world2)(mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


class _World:
    """`size` ranks of this file's __main__, started at once; results()
    waits for all of them (RANK_TIMEOUT_S), kills any left on the way out,
    and raises with a failed rank's output."""

    def __init__(self, size: int, tmp: pathlib.Path):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = "1"
        self.tmp = tmp
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(size), str(r), str(tmp / "store"),
                              str(tmp)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(size)]
        self._results = None

    def results(self):
        if self._results is None:
            deadline = time.time() + RANK_TIMEOUT_S
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
            finally:
                self.close()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log.decode(errors='replace')}"
            self._results = [torch.load(self.tmp / f"rank{r}.pt") for r in range(len(self.procs))]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started together at the file's first use."""
    ws = {n: _World(n, tmp_path_factory.mktemp(f"world{n}")) for n in (4, 2)}
    yield ws
    for w in ws.values():
        w.close()


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4]


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


# ---------------------------------------------------------------------------
# W = 4 against the reference
# ---------------------------------------------------------------------------


def _jax_mesh(n):
    from scaloam_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(n)


def test_sharded_pgo_matches_reference(world4):
    import jax.numpy as jnp
    from scaloam_tpu.config import PGOConfig as JPGOConfig
    from scaloam_tpu.models import posegraph as jpg
    from scaloam_tpu.parallel import pgo as jpgo
    from scaloam_tpu.types import Pose as JPose

    quats, trans, zq, zt = _pgo_inputs()
    cfg = JPGOConfig(**PGO_CFG)
    g = jpg.init_graph(cfg)
    for k in range(PGO_NODES):
        g = jpg.add_keyframe(g, JPose(jnp.asarray(quats[k]), jnp.asarray(trans[k])),
                             jnp.float32(0.1), jnp.asarray(k % 3 == 0), n_nodes=k)
    g = jpg.add_loop(g, jnp.int32(PGO_NODES - 1), jnp.int32(0),
                     JPose(jnp.asarray(zq), jnp.asarray(zt)), n_loops=0)
    want = jpgo.optimize_sharded(g, cfg, _jax_mesh(4), cg_iters=48)
    wq = np.asarray(want.poses.quat)[:PGO_NODES]
    wt = np.asarray(want.poses.trans)[:PGO_NODES]
    assert np.abs(wt - trans).max() > 0.05  # the loop moved the chain
    for r, res in enumerate(world4.results()):
        np.testing.assert_allclose(res["pgo_t"].numpy()[:PGO_NODES], wt, atol=5e-3, rtol=0,
                                   err_msg=r)
        dots = np.abs(np.sum(res["pgo_q"].numpy()[:PGO_NODES] * wq, axis=-1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4, err_msg=r)


def test_sharded_sc_retrieval_matches_reference(world4):
    import jax.numpy as jnp
    from scaloam_tpu.config import ScanContextConfig as JSCConfig
    from scaloam_tpu.parallel import sc_retrieval as jsc

    desc, keys, count, query = _sc_inputs()
    idx, yaw, dist = jsc.detect_loop_sharded(
        _jax_mesh(4), jnp.asarray(query), jnp.asarray(desc), jnp.asarray(keys),
        jnp.int32(count), JSCConfig(**SC_CFG))
    for r, res in enumerate(world4.results()):
        got = res["loop"].numpy()
        assert int(got[0]) == int(idx) >= 0, r
        assert got[1] == np.float64(np.float32(yaw)), r
        assert abs(got[2] - float(dist)) <= 1e-6, r


def test_sharded_knn_grid_matches_reference(world4):
    import jax.numpy as jnp
    from scaloam_tpu.ops import gridmap as jgm
    from scaloam_tpu.parallel import gridmap as jpgrid

    pts, count, coord, q, qm = _grid_inputs()
    grid = jgm.GridMap(jnp.asarray(pts), jnp.asarray(count), jnp.asarray(coord),
                       jnp.int32(count.sum()))
    d, nn = jpgrid.knn_grid_sharded(_jax_mesh(4), grid, jnp.asarray(q), jnp.asarray(qm),
                                    GX, GY, GZ, CS, reach=1.0, k=5)
    d, nn = np.asarray(d), np.asarray(nn)
    close = d < 1.0
    assert close.sum() > 150
    for r, res in enumerate(world4.results()):
        np.testing.assert_allclose(res["knn_d"].numpy(), d, atol=1e-5, rtol=3e-7, err_msg=r)
        np.testing.assert_allclose(np.sort(res["knn_nn"].numpy()[close], axis=-1),
                                   np.sort(nn[close], axis=-1), atol=1e-5, err_msg=r)


def test_dryrun_2d_layout_on_four_ranks(world4):
    res = world4.results()
    for r in res:
        assert r["dry_layout"] == {"seq": 2, "kf": 2}
        assert r["dry_loop"][0] == 0  # the query is keyframe 0's descriptor
        for key in ("dry_mapped", "dry_graph"):
            assert torch.isfinite(r[key]).all(), key
    for key in ("dry_mapped", "dry_graph", "dry_loop"):
        assert all(torch.equal(r[key], res[0][key]) for r in res), key


def test_sharded_pgo_matches_single_device(world4):
    """Sharded over 4 ranks against optimize's chain-CG step on one (the
    sums run in another order: tests/test_parallel.py's 5e-3 m)."""
    for r, res in enumerate(world4.results()):
        np.testing.assert_allclose(res["pgo_t"].numpy()[:PGO_NODES],
                                   res["single_t"].numpy()[:PGO_NODES], atol=5e-3, err_msg=r)


# ---------------------------------------------------------------------------
# W = 2: the multi-sequence front end
# ---------------------------------------------------------------------------


def _stack_pose(p):
    return torch.cat([p.quat, p.trans], dim=-1)


def test_multiseq_equals_one_sequence_at_a_time(world2):
    """Bit for bit: the same stages in the same order at one thread."""
    cfg = _reduced(tconfig)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_o, want_m = [], []
        for scans in _seq_scans():
            o, m = todo.init_state(cfg, "cpu"), tmap.init_state(cfg, "cpu")
            for f, pts in enumerate(scans):
                feats = tfeat.extract_features(LidarScan.from_numpy(pts, cfg.sensor.max_points,
                                                                    "cpu"), cfg)
                o, o_out = todo.odometry_step(o, feats, cfg)
                m, m_out = tmap.mapping_step(m, o_out.world, feats.less_sharp,
                                             feats.less_flat, cfg)
                want_o.append(_stack_pose(o_out.world))
                want_m.append(_stack_pose(m_out.pose))
    finally:
        torch.set_num_threads(threads)
    # [sequence, frame] -> [frame, sequence]
    want_o = torch.stack(want_o).reshape(N_SEQ, N_FRAMES, 7).transpose(0, 1)
    want_m = torch.stack(want_m).reshape(N_SEQ, N_FRAMES, 7).transpose(0, 1)
    for res in world2.results():
        assert res["local"] == 1  # this rank's row of the stacked states
        assert torch.equal(res["odom"], want_o)
        assert torch.equal(res["mapped"], want_m)
    assert float(want_m[-1, :, 4:].abs().max()) > 0.5  # the drives moved


@pytest.mark.slow  # the reference's three stages compile for ~25 s
def test_multiseq_matches_reference_stages(world2):
    import jax.numpy as jnp  # noqa: F401  (JAX is imported only here)
    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import mapping as jmap, odometry as jodo
    from scaloam_tpu.ops import features as jfeat
    from scaloam_tpu.ops.pallas import selection as jsel
    from scaloam_tpu.types import LidarScan as JScan

    cfg = _reduced(jconfig)
    orig = jsel.select_features

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jsel.select_features = interp
    try:
        want = []
        for scans in _seq_scans():
            o, m = jodo.init_state(cfg), jmap.init_state(cfg)
            for pts in scans:
                feats = jfeat.extract_features(JScan.from_numpy(pts, cfg.sensor.max_points), cfg)
                o, o_out = jodo.odometry_step(o, feats, cfg)
                m, m_out = jmap.mapping_step(m, o_out.world, feats.less_sharp,
                                             feats.less_flat, cfg)
                want.append((np.asarray(m_out.pose.quat), np.asarray(m_out.pose.trans)))
    finally:
        jsel.select_features = orig
    got = world2.results()[0]["mapped"].numpy()
    for s in range(N_SEQ):
        for f in range(N_FRAMES):
            wq, wt = want[s * N_FRAMES + f]
            q = got[f, s, :4] * np.sign(np.dot(got[f, s, :4], wq))
            np.testing.assert_allclose(q, wq, atol=Q_TOL, rtol=0, err_msg=(s, f))
            np.testing.assert_allclose(got[f, s, 4:], wt, atol=T_TOL, rtol=0, err_msg=(s, f))


# ---------------------------------------------------------------------------
# mesh helpers and distributed.initialize
# ---------------------------------------------------------------------------


def test_pad_to_shards():
    assert [tmesh.pad_to_shards(n, 4) for n in (1, 4, 5, 8, 256)] == [4, 4, 8, 8, 256]


def test_initialize_single_process_noop(monkeypatch):
    """No rendezvous requested and no launcher's environment: nothing is
    initialised and nothing raises."""
    import torch.distributed as dist

    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    distributed.initialize(world_size=1, rank=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.global_mesh("cpu")


def test_initialize_bad_request_raises():
    """A requested multi-process run it cannot meet raises, never degrades
    to one process: a rank without a rendezvous address, and a rank whose
    store does not answer within the timeout. In a subprocess, so a failed
    partial initialisation cannot touch this process."""
    with socket.socket() as s:  # a local port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import sys, time\n"
        "from scaloam_tpu_torch.parallel import distributed\n"
        f"for kw in (dict(world_size=2, rank=1),\n"
        f"           dict(init_method='tcp://127.0.0.1:{port}', world_size=2, rank=1,\n"
        "                backend='gloo', timeout=2)):\n"
        "    t0 = time.time()\n"
        "    try:\n"
        "        distributed.initialize(**kw)\n"
        "    except Exception as e:\n"
        "        print('RAISED', type(e).__name__, round(time.time() - t0, 1))\n"
        "        continue\n"
        "    sys.exit(1)\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RAISED")]
    assert len(lines) == 2, r.stdout + r.stderr
    assert float(lines[1].split()[-1]) < 60  # within the short timeout


def test_make_mesh_refuses_meshes_off_the_world(world2):
    assert [res["refused"] for res in world2.results()] == [4, 4]


# ---------------------------------------------------------------------------
# the backend device on the CPU
# ---------------------------------------------------------------------------


def _backend_cfg():
    cfg = _reduced(tconfig)
    return cfg.replace(pgo=dataclasses.replace(cfg.pgo, keyframe_meter_gap=0.5,
                                               optimize_every_n_keyframes=2))


@pytest.fixture(scope="module")
def backend_scans():
    return synthetic.simulate_trajectory(synthetic.make_world(seed=8), n_frames=3, speed=0.8,
                                         radius=25.0, n_azimuth=256, seed=3)[0]


def _drive(scans, **kw):
    s = tpipe.SlamSystem(_backend_cfg(), device="cpu", **kw)
    frames = [s.process_scan(p, time=0.1 * i) for i, p in enumerate(scans)]
    return s, frames


def test_backend_device_system_matches_single_device(backend_scans, tmp_path):
    one, f1 = _drive(backend_scans)
    two, f2 = _drive(backend_scans, backend_device="cpu")
    assert two.backend_device == torch.device("cpu")
    assert two.graph.poses.quat.device == two.sc.db.descriptors.device == torch.device("cpu")
    for a, b in zip(f1, f2):
        assert (a.is_keyframe, a.loop_found) == (b.is_keyframe, b.loop_found)
        assert torch.equal(_stack_pose(a.mapped_pose), _stack_pose(b.mapped_pose))
    assert len(two.keyframes) == len(one.keyframes) >= 3 and two.loops_found == one.loops_found
    np.testing.assert_array_equal(two.optimized_poses(), one.optimized_poses())

    one.save_session(str(tmp_path / "s"))
    r1 = tpipe.SlamSystem.resume(str(tmp_path / "s"), _backend_cfg(), device="cpu")
    r2 = tpipe.SlamSystem.resume(str(tmp_path / "s"), _backend_cfg(), device="cpu",
                                 backend_device="cpu")
    assert r2.backend_device == torch.device("cpu") and len(r2.keyframes) == len(one.keyframes)
    np.testing.assert_array_equal(r2.optimized_poses(), r1.optimized_poses())
    assert torch.equal(r2.sc.db.descriptors, r1.sc.db.descriptors)
    assert torch.equal(r2.gate_state.last_trans, r1.gate_state.last_trans)


def test_backend_device_async_pipeline(backend_scans):
    pipe = AsyncSlamPipeline(_backend_cfg(), drop_backlog=False, device="cpu",
                             backend_device="cpu")
    assert pipe.backend_device == torch.device("cpu")
    pipe.start()
    for i, s in enumerate(backend_scans):
        pipe.feed(0.1 * i, s)
    pipe.finish(timeout=300.0)
    assert pipe.workers_alive == 0 and len(pipe.mapped_results) == len(backend_scans)
    assert pipe.dropped_frames == 0 and len(pipe.sys.keyframes) >= 3
    with pytest.raises(ValueError, match="backend_device"):
        AsyncSlamPipeline(_backend_cfg(), system=pipe.sys, backend_device="meta")


@pytest.mark.parametrize("index", ["0", "1"])
def test_cli_backend_device_out_of_range(index, capsys):
    """Without that CUDA card --backend-device N exits 2 (this machine has
    none, so every index is out of range)."""
    if torch.cuda.device_count() > int(index):
        pytest.skip("the card exists here")
    argv = ["--preset", "vlp16", "--synthetic", "2", "--device", "cpu", "--backend-device", index]
    assert trun.main(argv) == 2
    assert "out of range" in capsys.readouterr().err


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
