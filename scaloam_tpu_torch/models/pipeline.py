"""Keyframe gate and keyframe-cloud prep (counterpart of the front-end
pieces of scaloam_tpu/models/pipeline.py: GateState, init_gate_state,
gate_step, _prepare_keyframe). SlamSystem is not ported yet."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scaloam_tpu_torch import device as _device
from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.ops import se3, voxel


class GateState(NamedTuple):
    """Keyframe-gate state: accumulated motion since the last keyframe."""

    last_quat: torch.Tensor  # [4]
    last_trans: torch.Tensor  # [3]
    trans_accum: torch.Tensor  # f32 scalar
    rot_accum: torch.Tensor  # f32 scalar
    initialized: torch.Tensor  # bool scalar


def init_gate_state(device=None) -> GateState:
    dev = _device.resolve(device)
    return GateState(
        last_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev),
        last_trans=torch.zeros(3, dtype=torch.float32, device=dev),
        trans_accum=torch.zeros((), dtype=torch.float32, device=dev),
        rot_accum=torch.zeros((), dtype=torch.float32, device=dev),
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
    )


def gate_step(gs: GateState, quat, trans, meter_gap: float, deg_gap: float):
    """One keyframe-gate update; returns (new_state, fire bool scalar).
    The first frame always fires; firing resets both accumulators."""
    dt = torch.sqrt(se3.sq_norm(trans - gs.last_trans))
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
