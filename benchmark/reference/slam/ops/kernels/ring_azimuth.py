"""The ring id, its validity and the raw azimuth of a scan's points: the
program's csrc/ring_azimuth.cu as its plain version, the same IEEE
operations in elementwise tensor ops.

`ring_azimuth(xyz [n, 3], lidar_type, n_scans)` returns

    ring    int32 [n]  the sensor's ring id of the vertical angle, clamped
    ring_ok bool  [n]  whether the angle lies inside the sensor's rings
    ori_raw f32   [n]  -atan2(y, x), the azimuth the sweep unwrap reads

with the reference's rounding (scaloam_tpu/ops/features.py:49-71, :91): the
C library's atan2f (ops/f32.py `atan2`), sqrt(x^2 + y^2) and `angle + c` as
its compiled code forms them (one fused multiply-add, a correctly rounded
root). The range image gathers ori_raw in its sorted order, where the
reference calls atan2 again (:114).
"""

import math

import torch
from torch import Tensor

from reference.slam.ops import f32

_DEG = 180.0 / math.pi
LIDAR_CODES = {"VLP16": 0, "HDL32": 1, "HDL64": 2, "OS1-64": 3}  # csrc/ring_azimuth.cu


def ring_azimuth(xyz: Tensor, lidar_type: str, n_scans: int):
    """(ring, ring_ok, ori_raw) of the points xyz [n, 3] (module docstring)."""
    if lidar_type not in LIDAR_CODES:
        raise ValueError(f"unknown lidar_type {lidar_type}")
    return ring_azimuth_plain(xyz, lidar_type, n_scans)


def ring_azimuth_plain(xyz: Tensor, lidar_type: str, n_scans: int):
    """The kernel's arithmetic in PyTorch ops. C++ int() truncates toward
    zero."""
    x, y, z = xyz.unbind(-1)
    # The top HDL-64 beam sits exactly on the 2 degree bound, so the last
    # ulp of the angle decides validity there: form sqrt(x^2 + y^2) as the
    # reference's compiled code does (one fused multiply-add, correctly
    # rounded square root).
    hyp = f32.sqrt(f32.fma_f32(x, x, y * y))
    # atan2 as the reference's C library rounds it: beams of the synthetic
    # OS1-64 sit exactly on its ring bounds, where the last ulp decides.
    rad = f32.atan2(z, hyp)

    def trunc(v):
        return torch.trunc(v).to(torch.int32)

    # Where the angle feeds one sum, the reference's compiled code forms
    # angle + c as one fused multiply-add of the radians.
    if lidar_type == "VLP16":
        sid = trunc(f32.fma_f32(rad, _DEG, 15.0) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL32":
        sid = trunc(f32.fma_f32(rad, _DEG, 92.0 / 3.0) * 3.0 / 4.0)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL64":
        angle = rad * _DEG
        upper = trunc((2.0 - angle) * 3.0 + 0.5)
        lower = n_scans // 2 + trunc((-8.83 - angle) * 2.0 + 0.5)
        sid = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    elif lidar_type == "OS1-64":
        sid = trunc(f32.fma_f32(rad, _DEG, 22.5) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    else:
        raise ValueError(f"unknown lidar_type {lidar_type}")
    return torch.clamp(sid, 0, n_scans - 1), ok, -f32.atan2(y, x)
