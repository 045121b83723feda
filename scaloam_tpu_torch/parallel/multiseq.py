"""Data-parallel multi-sequence front end: each rank advances its share of
N lidar sequences (counterpart of scaloam_tpu/parallel/multiseq.py).

The SLAM state chain is sequential in time, so sequences, not frames, are
the front end's scale-out axis. Sequences shard over the mesh's `seq` axis
(or the only axis of a 1-D mesh); on a 2-D (seq, kf) mesh the ranks of one
`kf` row advance the same sequences, as the reference's P(SEQ_AXIS) is
replicated over `kf`. No collective runs in a frame. Each local sequence
runs features -> odometry -> mapping in turn, launching K1, K2 entry A
and K2 entry B as the single-sequence front end does. The stage wiring is
the reference multiseq's own: mapping takes the features' less_sharp /
less_flat clouds, not odometry's republished ones.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.models import mapping as mapping_mod
from scaloam_tpu_torch.models import odometry as odometry_mod
from scaloam_tpu_torch.ops import features
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel.mesh import SEQ_AXIS
from scaloam_tpu_torch.types import LidarScan, Pose


def _seq_axis(mesh) -> str:
    """SEQ_AXIS on a 2-D (seq, kf) mesh, else the 1-D mesh's only axis."""
    names = mesh.mesh_dim_names
    if SEQ_AXIS in names:
        return SEQ_AXIS
    if len(names) != 1:
        raise ValueError(f"no sequence axis on a mesh with axes {names}")
    return names[0]


def _local_range(n_seq: int, mesh) -> Tuple[int, int]:
    axis = _seq_axis(mesh)
    n = mesh_mod.axis_size(mesh, axis)
    if n_seq % n:
        raise ValueError(f"{n_seq} sequences do not shard over the {n} ranks of axis {axis}")
    per = n_seq // n
    lo = mesh_mod.axis_index(mesh, axis) * per
    return lo, lo + per


def init_states(n_seq: int, cfg: SlamConfig, device=None) -> Tuple[List, List]:
    """Fresh odometry and mapping states, one of each per sequence."""
    return ([odometry_mod.init_state(cfg, device) for _ in range(n_seq)],
            [mapping_mod.init_state(cfg, device) for _ in range(n_seq)])


def shard_states(states, mesh):
    """This rank's sequences of (odometry states, mapping states)."""
    o_states, m_states = states
    lo, hi = _local_range(len(o_states), mesh)
    return o_states[lo:hi], m_states[lo:hi]


def frame_batch(o_states, m_states, scans_xyz: torch.Tensor, scans_mask: torch.Tensor,
                cfg: SlamConfig, mesh=None):
    """Advance each local sequence by one frame.

    scans_xyz [n_seq, max_points, 3], scans_mask [n_seq, max_points]: with
    a mesh, every sequence's scan, of which this rank takes its own rows;
    without one, the local sequences' scans. Returns (o_states, m_states,
    odometry poses, mapped poses), the poses stacked over the local
    sequences ([n_local]; `gather_poses` collects all sequences')."""
    if mesh is not None:
        lo, hi = _local_range(scans_xyz.shape[0], mesh)
        scans_xyz, scans_mask = scans_xyz[lo:hi], scans_mask[lo:hi]
    if scans_xyz.shape[0] != len(o_states):
        raise ValueError(f"{scans_xyz.shape[0]} scans for {len(o_states)} local sequences")
    o_out_states, m_out_states, odom, mapped = [], [], [], []
    for o_state, m_state, xyz, mask in zip(o_states, m_states, scans_xyz, scans_mask):
        feats = features.extract_features(LidarScan(xyz, mask), cfg)
        o_state, o_out = odometry_mod.odometry_step(o_state, feats, cfg)
        m_state, m_out = mapping_mod.mapping_step(
            m_state, o_out.world, feats.less_sharp, feats.less_flat, cfg)
        o_out_states.append(o_state)
        m_out_states.append(m_state)
        odom.append(o_out.world)
        mapped.append(m_out.pose)

    def stack(poses):
        return Pose(torch.stack([p.quat for p in poses]), torch.stack([p.trans for p in poses]))

    return o_out_states, m_out_states, stack(odom), stack(mapped)


def gather_poses(poses: Pose, mesh) -> Pose:
    """Every sequence's poses [n_seq], in sequence order, from each rank's
    local [n_local] poses (an all_gather over the sequence axis)."""
    axis = _seq_axis(mesh)
    qt = mesh_mod.all_gather(torch.cat([poses.quat, poses.trans], dim=-1), mesh, axis)
    qt = qt.reshape(-1, 7)
    return Pose(qt[:, :4], qt[:, 4:])
