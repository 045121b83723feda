"""Carry front-end state across from the JAX reference.

The system has no weights: its carried state is the odometry state, the
mapping state (two torus grid maps) and the keyframe-gate state.
`state_from_numpy` takes that state as nested NamedTuples or dicts of
numpy arrays (for a JAX state: `jax.tree.map(np.asarray, state)`) and
builds the port's FrontendState on `device`, so both implementations can
start from the same mid-run map.
"""

from __future__ import annotations

import numpy as np
import torch

from scaloam_tpu_torch.models.frontend import FrontendState
from scaloam_tpu_torch.models.mapping import MappingState
from scaloam_tpu_torch.models.odometry import OdometryState
from scaloam_tpu_torch.models.pipeline import GateState
from scaloam_tpu_torch.ops.gridmap import GridMap
from scaloam_tpu_torch.types import FeatureCloud, Pose


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _leaves(cls, tree, device, **convert):
    """cls(**fields) with each field from tree, by default as a tensor."""
    return cls(**{
        f: convert.get(f, lambda v: torch.as_tensor(np.asarray(v)).to(device))(_get(tree, f))
        for f in cls._fields
    })


def pose_from_numpy(tree, device) -> Pose:
    return _leaves(Pose, tree, device)


def odometry_state_from_numpy(tree, device) -> OdometryState:
    return _leaves(
        OdometryState, tree, device,
        last_corner=lambda t: _leaves(FeatureCloud, t, device),
        last_surf=lambda t: _leaves(FeatureCloud, t, device),
        rel=lambda t: pose_from_numpy(t, device),
        world=lambda t: pose_from_numpy(t, device),
        initialized=lambda v: bool(np.asarray(v)),
    )


def mapping_state_from_numpy(tree, device) -> MappingState:
    return _leaves(
        MappingState, tree, device,
        corner_grid=lambda t: _leaves(GridMap, t, device),
        surf_grid=lambda t: _leaves(GridMap, t, device),
        correction=lambda t: pose_from_numpy(t, device),
        pose=lambda t: pose_from_numpy(t, device),
    )


def gate_state_from_numpy(tree, device) -> GateState:
    return _leaves(GateState, tree, device)


def state_from_numpy(tree, device) -> FrontendState:
    return FrontendState(
        o=odometry_state_from_numpy(_get(tree, "o"), device),
        m=mapping_state_from_numpy(_get(tree, "m"), device),
        gate=gate_state_from_numpy(_get(tree, "gate"), device),
    )
