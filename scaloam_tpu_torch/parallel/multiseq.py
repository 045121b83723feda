"""Data-parallel multi-sequence front end: each rank advances its share of
N lidar sequences as one batched program (counterpart of
scaloam_tpu/parallel/multiseq.py).

The SLAM state chain is sequential in time, so sequences, not frames, are
the front end's scale-out axis. As in the reference, the states are
stacked on a leading sequence axis and one frame of every local sequence
is one `torch.func.vmap` of the per-sequence step (features -> odometry ->
mapping): every op runs once for the whole batch, and so do the kernels,
whose vmap rules fold the batch into one launch (K1 over B x S rows, K2's
entries over B clusters). The per-sample fallback, which would loop over
the batch where an op has no batching rule, is refused (its warning is
raised as an error). Sequences shard over the mesh's `seq` axis (or the
only axis of a 1-D mesh); on a 2-D (seq, kf) mesh the ranks of one `kf`
row advance the same sequences, as the reference's P(SEQ_AXIS) is
replicated over `kf`. No collective runs in a frame. The stage wiring is
the reference multiseq's own: mapping takes the features' less_sharp /
less_flat clouds, not odometry's republished ones.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.models import mapping as mapping_mod
from scaloam_tpu_torch.models import odometry as odometry_mod
from scaloam_tpu_torch.ops import features
from scaloam_tpu_torch.parallel import mesh as mesh_mod
from scaloam_tpu_torch.parallel.mesh import SEQ_AXIS
from scaloam_tpu_torch.types import LidarScan, Pose

# The warning torch.func.vmap gives where it loops over the batch.
FALLBACK_WARNING = "There is a performance drop"


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


def _tree_map(fn, tree):
    """fn on every leaf of nested NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


def _tensors(fn):
    """fn on tensor leaves; other leaves (the host `initialized` flag) as
    they are."""
    return lambda x: fn(x) if isinstance(x, torch.Tensor) else x


def init_states(n_seq: int, cfg: SlamConfig, device=None):
    """Fresh odometry and mapping states, stacked: every tensor with a
    leading [n_seq] axis (the odometry state's host `initialized` flag,
    False, holds for all)."""
    stack = _tensors(lambda x: x.expand(n_seq, *x.shape).clone())
    return (_tree_map(stack, odometry_mod.init_state(cfg, device)),
            _tree_map(stack, mapping_mod.init_state(cfg, device)))


def num_sequences(o_states) -> int:
    """The leading axis of stacked states."""
    return o_states.frame_idx.shape[0]


def shard_states(states, mesh):
    """This rank's rows of stacked (odometry, mapping) states."""
    o_states, m_states = states
    lo, hi = _local_range(num_sequences(o_states), mesh)
    rows = _tensors(lambda x: x[lo:hi])
    return _tree_map(rows, o_states), _tree_map(rows, m_states)


def frame_batch(o_states, m_states, scans_xyz: torch.Tensor, scans_mask: torch.Tensor,
                cfg: SlamConfig, mesh=None):
    """Advance each local sequence by one frame, all in one vmapped step.

    o_states, m_states: stacked states of the local sequences ([n_local]
    leading axes; `initialized` a host bool for all, or a bool tensor
    [n_local] where the sequences' flags differ). scans_xyz [n_seq,
    max_points, 3], scans_mask [n_seq, max_points]: with a mesh, every
    sequence's scan, of which this rank takes its own rows; without one,
    the local sequences' scans. Returns (o_states, m_states, odometry
    poses, mapped poses), the poses [n_local] (`gather_poses` collects all
    sequences'). Raises if vmap falls back to a per-sequence loop."""
    if mesh is not None:
        lo, hi = _local_range(scans_xyz.shape[0], mesh)
        scans_xyz, scans_mask = scans_xyz[lo:hi], scans_mask[lo:hi]
    n_local = num_sequences(o_states)
    if scans_xyz.shape[0] != n_local:
        raise ValueError(f"{scans_xyz.shape[0]} scans for {n_local} local sequences")
    flag = o_states.initialized
    host_flag = isinstance(flag, bool)

    def one(o_tensors, m_state, xyz, mask, initialized):
        o_state = _join(o_tensors, flag if host_flag else initialized)
        feats = features.extract_features(LidarScan(xyz, mask), cfg)
        o_state, o_out = odometry_mod.odometry_step(o_state, feats, cfg)
        m_state, m_out = mapping_mod.mapping_step(
            m_state, o_out.world, feats.less_sharp, feats.less_flat, cfg)
        return _split(o_state), m_state, o_out.world, m_out.pose

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK_WARNING)
        o_out, m_out, odom, mapped = torch.func.vmap(
            one, in_dims=(0, 0, 0, 0, None if host_flag else 0))(
            _split(o_states), m_states, scans_xyz, scans_mask, None if host_flag else flag)
    return _join(o_out, True), m_out, odom, mapped


# The odometry state's tensor fields: vmap maps tensors only, so the host
# flag rides beside them.
_O_TENSORS = tuple(f for f in odometry_mod.OdometryState._fields if f != "initialized")


def _split(o_state) -> tuple:
    return tuple(getattr(o_state, f) for f in _O_TENSORS)


def _join(o_tensors, initialized):
    return odometry_mod.OdometryState(initialized=initialized, **dict(zip(_O_TENSORS, o_tensors)))


def gather_poses(poses: Pose, mesh) -> Pose:
    """Every sequence's poses [n_seq], in sequence order, from each rank's
    local [n_local] poses (an all_gather over the sequence axis)."""
    axis = _seq_axis(mesh)
    qt = mesh_mod.all_gather(torch.cat([poses.quat, poses.trans], dim=-1), mesh, axis)
    qt = qt.reshape(-1, 7)
    return Pose(qt[:, :4], qt[:, 4:])
