"""The per-scan front end: features -> odometry -> mapping -> keyframe
gate, plus the keyframe-cloud voxel prep on frames where the gate fires
(counterpart of scaloam_tpu/models/frontend.py).

`FrontEnd(cfg, device=None)` holds the state and is the entry point;
`frontend_step` is the pure step on explicit state. The gate flag is read
back to the host once per frame to decide whether to run the keyframe
prep (the reference's `lax.cond`): the one device-to-host sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scaloam_tpu_torch import device as _device
from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.models import mapping as mapping_mod
from scaloam_tpu_torch.models import odometry as odometry_mod
from scaloam_tpu_torch.models import pipeline as pipeline_mod
from scaloam_tpu_torch.ops import features
from scaloam_tpu_torch.types import LidarScan, Pose


class FrontendState(NamedTuple):
    o: odometry_mod.OdometryState
    m: mapping_mod.MappingState
    gate: pipeline_mod.GateState


class FrontendOutput(NamedTuple):
    odom_world: Pose  # /laser_odom_to_init
    mapped_pose: Pose  # /aft_mapped_to_init
    fire: torch.Tensor  # bool scalar: keyframe gate fired
    degenerate: torch.Tensor  # bool scalar (odometry correspondence guard)
    # Keyframe cloud: real data only when fire, zeros otherwise.
    kf_xyz: torch.Tensor  # [C, 3]
    kf_mask: torch.Tensor  # [C]
    kf_ext: torch.Tensor  # [C, 1]


def init_state(cfg: SlamConfig, device=None) -> FrontendState:
    dev = _device.resolve(device)
    return FrontendState(
        o=odometry_mod.init_state(cfg, dev),
        m=mapping_mod.init_state(cfg, dev),
        gate=pipeline_mod.init_gate_state(dev),
    )


def frontend_step(state: FrontendState, scan: LidarScan, cfg: SlamConfig):
    """Process one raw scan; returns (new_state, FrontendOutput)."""
    feats = features.extract_features(scan, cfg)
    o_state, o_out = odometry_mod.odometry_step(state.o, feats, cfg)
    # Mapping consumes odometry's republished clouds (post-step last_*).
    m_state, m_out = mapping_mod.mapping_step(
        state.m, o_out.world, o_state.last_corner, o_state.last_surf, cfg
    )
    gate, fire = pipeline_mod.gate_step(
        state.gate, m_out.pose.quat, m_out.pose.trans,
        float(cfg.pgo.keyframe_meter_gap), float(cfg.pgo.keyframe_deg_gap),
    )
    full = feats.full
    if bool(fire):  # device -> host read of the gate flag
        kf_xyz, kf_mask, kf_ext = pipeline_mod._prepare_keyframe(
            full.xyz, full.mask, full.rel_time, cfg
        )
    else:
        # The prep's output length: its capacity, bounded by the input size.
        n = min(cfg.pgo.keyframe_cloud_capacity, full.mask.numel())
        dev = full.xyz.device
        kf_xyz = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        kf_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        kf_ext = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    new_state = FrontendState(o=o_state, m=m_state, gate=gate)
    return new_state, FrontendOutput(
        odom_world=o_out.world, mapped_pose=m_out.pose, fire=fire,
        degenerate=o_out.degenerate, kf_xyz=kf_xyz, kf_mask=kf_mask, kf_ext=kf_ext,
    )


class FrontEnd:
    """The front end with its state: `step(xyz, mask)` per raw scan, where
    xyz [N, 3] f32 and mask [N] bool lie on this front end's device
    (N = cfg.sensor.max_points; see LidarScan.from_numpy). Runs on `cuda`
    unless another device is named; raises without a GPU and a device."""

    def __init__(self, cfg: SlamConfig, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.state = init_state(cfg, self.device)

    def step(self, xyz: torch.Tensor, mask: torch.Tensor) -> FrontendOutput:
        self.state, out = frontend_step(self.state, LidarScan(xyz, mask), self.cfg)
        return out
