"""Carry state across from the JAX reference.

The system has no weights: its carried state is the odometry state, the
mapping state (two torus grid maps), the keyframe-gate state and the
backend (pose graph, ScanContext database, keyframe clouds). Each
`*_from_numpy` takes that state as nested NamedTuples or dicts of numpy
arrays (for a JAX state: `jax.tree.map(np.asarray, state)`) and builds the
port's counterpart on `device`, so both implementations can start from the
same mid-run state.
"""

from __future__ import annotations

import numpy as np
import torch

from scaloam_tpu_torch.models.frontend import FrontendState
from scaloam_tpu_torch.models.mapping import MappingState
from scaloam_tpu_torch.models.odometry import OdometryState
from scaloam_tpu_torch.models.pipeline import GateState
from scaloam_tpu_torch.models.posegraph import PoseGraph
from scaloam_tpu_torch.models.scancontext import SCDatabase
from scaloam_tpu_torch.ops.gridmap import GridMap
from scaloam_tpu_torch.types import FeatureCloud, Pose


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _leaves(cls, tree, device, **convert):
    """cls(**fields) with each field from tree, by default as a tensor."""
    return cls(**{
        f: convert.get(f, lambda v: torch.as_tensor(np.array(v)).to(device))(_get(tree, f))
        for f in cls._fields
    })


def pose_from_numpy(tree, device) -> Pose:
    return _leaves(Pose, tree, device)


def _initialized(v, device):
    """The reference's device flag(s) as the port's: a host bool where
    every flag agrees (one state, or a batch started together), else a
    bool tensor, one flag a sequence."""
    flags = np.asarray(v, dtype=bool)
    if flags.size and bool((flags == flags.flat[0]).all()):
        return bool(flags.flat[0])
    return torch.as_tensor(flags).to(device)


def odometry_state_from_numpy(tree, device) -> OdometryState:
    return _leaves(
        OdometryState, tree, device,
        last_corner=lambda t: _leaves(FeatureCloud, t, device),
        last_surf=lambda t: _leaves(FeatureCloud, t, device),
        rel=lambda t: pose_from_numpy(t, device),
        world=lambda t: pose_from_numpy(t, device),
        initialized=lambda v: _initialized(v, device),
    )


def mapping_state_from_numpy(tree, device) -> MappingState:
    return _leaves(
        MappingState, tree, device,
        corner_grid=lambda t: _leaves(GridMap, t, device),
        surf_grid=lambda t: _leaves(GridMap, t, device),
        correction=lambda t: pose_from_numpy(t, device),
        pose=lambda t: pose_from_numpy(t, device),
    )


def multiseq_states_from_numpy(o_tree, m_tree, device):
    """The reference multiseq's stacked states (every leaf with a leading
    n_seq axis, as scaloam_tpu.parallel.multiseq.init_states and
    frame_batch give them) as the port's stacked (odometry, mapping)
    states; `initialized` becomes a host bool where every sequence's flag
    agrees, else a bool tensor [n_seq]."""
    return odometry_state_from_numpy(o_tree, device), mapping_state_from_numpy(m_tree, device)


def gate_state_from_numpy(tree, device) -> GateState:
    return _leaves(GateState, tree, device)


def state_from_numpy(tree, device) -> FrontendState:
    return FrontendState(
        o=odometry_state_from_numpy(_get(tree, "o"), device),
        m=mapping_state_from_numpy(_get(tree, "m"), device),
        gate=gate_state_from_numpy(_get(tree, "gate"), device),
    )


def graph_from_numpy(tree, device) -> PoseGraph:
    """A pose graph (loop indices as int64, counts as int32)."""
    as_t = lambda dt: (lambda v: torch.as_tensor(np.array(v)).to(device, dt))
    pose = lambda t: pose_from_numpy(t, device)
    return _leaves(
        PoseGraph, tree, device, poses=pose, odom_poses=pose, odom_rel=pose,
        loop_rel=pose, loop_i=as_t(torch.int64), loop_j=as_t(torch.int64),
        n_nodes=as_t(torch.int32), n_loops=as_t(torch.int32),
    )


def sc_db_from_numpy(tree, device) -> SCDatabase:
    return _leaves(SCDatabase, tree, device,
                   count=lambda v: torch.as_tensor(np.array(v)).to(device, torch.int64))


def system_from_numpy(tree, cfg, device):
    """A SlamSystem carrying another system's backend state: `tree` is a
    dict with `graph`, `sc_db` (numpy trees as above), `keyframes` (dicts
    of cloud, intensity, time, frame), `gate`, `loops_found`,
    `gps_alt_offset`, `frame_idx`, and optionally the front-end states
    `o` and `m`."""
    from scaloam_tpu_torch.models.pipeline import Keyframe, SlamSystem

    s = SlamSystem(cfg, device=device)
    dev = s.device
    s.graph = graph_from_numpy(tree["graph"], dev)
    s.sc.db = sc_db_from_numpy(tree["sc_db"], dev)
    s.sc._n = int(np.asarray(_get(tree["sc_db"], "count")))
    s.keyframes = [
        Keyframe(cloud=np.asarray(k["cloud"], np.float32), time=float(k["time"]),
                 frame=int(k["frame"]),
                 intensity=None if k["intensity"] is None else np.asarray(k["intensity"]))
        for k in tree["keyframes"]
    ]
    s.kf_times = [k.time for k in s.keyframes]
    s.gate_state = gate_state_from_numpy(tree["gate"], dev)
    s.loops_found = [tuple(map(int, ij)) for ij in tree["loops_found"]]
    s._gps_alt_offset = tree["gps_alt_offset"]
    s.frame_idx = int(tree["frame_idx"])
    if "o" in tree:
        s.o_state = odometry_state_from_numpy(tree["o"], dev)
        s.m_state = mapping_state_from_numpy(tree["m"], dev)
    return s
