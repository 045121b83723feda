"""The keyframe gate and the keyframe cloud's prep (counterparts of
scaloam_tpu/models/pipeline.py's gate and prep), which the front end's
step runs after mapping."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference.slam.config import SlamConfig
from reference.slam.ops import se3, voxel
from reference.slam.ops.kernels import f32ops


class GateState(NamedTuple):
    """Keyframe-gate state: accumulated motion since the last keyframe."""

    last_quat: torch.Tensor  # [4]
    last_trans: torch.Tensor  # [3]
    trans_accum: torch.Tensor  # f32 scalar
    rot_accum: torch.Tensor  # f32 scalar
    initialized: torch.Tensor  # bool scalar


def gate_step(gs: GateState, quat, trans, meter_gap: float, deg_gap: float):
    """One keyframe-gate update; returns (new_state, fire bool scalar).
    The first frame always fires; firing resets both accumulators."""
    dt = torch.sqrt(f32ops.sum3_sq(trans - gs.last_trans))
    r, p, y = se3.quat_to_rpy(se3.quat_mul(se3.quat_conj(gs.last_quat), quat))
    live = gs.initialized
    ta = gs.trans_accum + torch.where(live, dt, 0.0)
    ra = gs.rot_accum + torch.where(live, torch.abs(r) + torch.abs(p) + torch.abs(y), 0.0)
    fire = ~live | (ta > meter_gap) | (ra > math.radians(deg_gap))
    new = GateState(
        last_quat=quat,
        last_trans=trans,
        trans_accum=torch.where(fire, 0.0, ta),
        rot_accum=torch.where(fire, 0.0, ra),
        initialized=torch.ones((), dtype=torch.bool, device=quat.device),
    )
    return new, fire


def _prepare_keyframe(ri_xyz, ri_mask, ri_rel_time, cfg: SlamConfig):
    """The keyframe cloud: the full-res local range image, 0.4 m voxel
    filtered, with the intensity channel (ring + scan_period * relTime)
    averaged alongside. Overflow drops the farthest voxels first."""
    n_rings = ri_xyz.shape[0]
    rings = torch.arange(n_rings, dtype=torch.float32, device=ri_xyz.device)[:, None]
    intens = (rings + float(cfg.sensor.scan_period) * ri_rel_time).reshape(-1, 1)
    return voxel.voxel_downsample_packed(
        ri_xyz.reshape(-1, 3), ri_mask.reshape(-1), cfg.pgo.keyframe_voxel_size,
        capacity=cfg.pgo.keyframe_cloud_capacity, extra=intens,
        xy_bits=10, z_bits=9, shell_bits=2,
    )
