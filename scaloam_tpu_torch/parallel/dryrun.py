"""The multi-device step over a real mesh, run by every rank of an
initialised world (counterpart of __graft_entry__.dryrun_multichip).

With a world of 4 or more ranks and an even count it uses the combined
2-D (seq, kf) layout: the multi-sequence front end over `seq` feeding one
factor-sharded backend (ScanContext retrieval and the distributed pose
graph) over `kf` of the same mesh; otherwise the 1-D layout, one sequence
per rank. The data comes from numpy's generator seeded 0, the same on
every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from scaloam_tpu_torch import config
from scaloam_tpu_torch.config import PGOConfig, ScanContextConfig, SlamConfig
from scaloam_tpu_torch.models import posegraph as pg
from scaloam_tpu_torch.models import scancontext as scm
from scaloam_tpu_torch.ops import se3
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel import multiseq, pgo, sc_retrieval
from scaloam_tpu_torch.types import Pose


def small_config() -> SlamConfig:
    """kitti_hdl64 with the reference dry run's reduced scan and feature
    capacities (__graft_entry__._small_cfg)."""
    cfg = config.kitti_hdl64()
    return cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=32768, max_points_per_ring=512),
        features=dataclasses.replace(cfg.features, max_sharp=512, max_less_sharp=2048,
                                     max_flat=1024, max_less_flat=8192),
    )


def dryrun(device, cfg: SlamConfig = None) -> dict:
    """Sharded ScanContext retrieval, the sharded pose graph and two frames
    of the multi-sequence front end (`cfg`, default small_config()) on
    `device`. Raises on a non-finite pose. Returns the layout, the
    retrieval triple, the optimised poses and every sequence's mapped
    poses of the last frame, the same on every rank."""
    device = torch.device(device)
    world = dist.get_world_size()
    if world >= 4 and world % 2 == 0:
        n_seq, n_kf = 2, world // 2
        mesh = mesh_mod.make_mesh2d(n_seq, n_kf, device.type)
    else:
        n_seq = n_kf = world
        mesh = mesh_mod.make_mesh(world, device.type)
    rng = np.random.default_rng(0)

    def dev_f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    # sharded ScanContext retrieval on a small database
    sc_cfg = ScanContextConfig(num_exclude_recent=2, num_candidates=2, max_keyframes=8 * n_kf)
    db = scm.init_db(sc_cfg, device)
    for k in range(3 * n_kf):
        desc = dev_f32(rng.uniform(0, 5, size=(sc_cfg.num_ring, sc_cfg.num_sector)))
        db = scm.append_descriptor(db, desc, count=k)
    loop = sc_retrieval.detect_loop_sharded(
        mesh, db.descriptors[0], mesh_mod.shard_rows(mesh, db.descriptors),
        mesh_mod.shard_rows(mesh, db.ring_keys), db.count, sc_cfg)

    # the distributed pose graph
    pgo_cfg = PGOConfig(max_keyframes=8 * n_kf, max_loops=2 * n_kf, gn_iterations=2)
    graph = pg.init_graph(pgo_cfg, device)
    pose = Pose.identity(device)
    poses = [pose]
    for k in range(3 * n_kf):
        dq = se3.exp_so3(dev_f32(rng.normal(0, 0.05, 3)))
        pose = Pose(se3.quat_mul(pose.quat, dq), pose.trans + dev_f32(rng.normal(0, 0.3, 3)))
        poses.append(pose)
        graph = pg.add_keyframe(graph, pose, 0.0, k % 2 == 0, n_nodes=k)
    graph = pg.add_loop(graph, 3 * n_kf - 1, 0, se3.relative(poses[-1], poses[1]), n_loops=0)
    out = pgo.optimize_sharded(graph, pgo_cfg, mesh, cg_iters=8)
    if not bool(torch.isfinite(out.poses.trans).all()):
        raise RuntimeError("dryrun: non-finite pose-graph poses")

    # the multi-sequence front end over the sequence axis: this rank's rows
    # of the stacked states, one vmapped step a frame
    cfg = small_config() if cfg is None else cfg
    o_states, m_states = multiseq.shard_states(multiseq.init_states(n_seq, cfg, device), mesh)
    npts = cfg.sensor.max_points
    xyz = dev_f32(rng.uniform(-30, 30, size=(n_seq, npts, 3)))
    mask = torch.ones((n_seq, npts), dtype=torch.bool, device=device)
    for _ in range(2):
        o_states, m_states, _, mapped = multiseq.frame_batch(
            o_states, m_states, xyz, mask, cfg, mesh=mesh)
    mapped = multiseq.gather_poses(mapped, mesh)
    if not bool(torch.isfinite(mapped.trans).all()):
        raise RuntimeError("dryrun: non-finite mapped poses")
    return {"layout": {a: mesh_mod.axis_size(mesh, a) for a in mesh.mesh_dim_names},
            "loop": loop, "graph_poses": out.poses, "mapped": mapped}
