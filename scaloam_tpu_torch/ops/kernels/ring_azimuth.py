"""The ring id, its validity and the raw azimuth of a scan's points in one
launch a frame on the card: a CUDA kernel (csrc/ring_azimuth.cu) and its
plain version, the same IEEE operations in elementwise tensor ops.

`ring_azimuth(xyz [n, 3], lidar_type, n_scans)` returns

    ring    int32 [n]  the sensor's ring id of the vertical angle, clamped
    ring_ok bool  [n]  whether the angle lies inside the sensor's rings
    ori_raw f32   [n]  -atan2(y, x), the azimuth the sweep unwrap reads

with the reference's rounding (scaloam_tpu/ops/features.py:49-71, :91): the
C library's atan2f (ops/f32.py `atan2`), sqrt(x^2 + y^2) and `angle + c` as
its compiled code forms them (one fused multiply-add, a correctly rounded
root). The range image gathers ori_raw in its sorted order, where the
reference calls atan2 again (:114).

Replaces no Pallas kernel: in the port this was three launches of
csrc/f32ops.cu's atan2 a frame and ~15 elementwise launches around the
first; the kernel is one. Under torch.func.vmap the batch of scans folds
into one launch.
"""

import ctypes
import math

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops import f32
from scaloam_tpu_torch.ops.kernels import _build

_DEG = 180.0 / math.pi
LIDAR_CODES = {"VLP16": 0, "HDL32": 1, "HDL64": 2, "OS1-64": 3}  # csrc/ring_azimuth.cu


def ring_azimuth(xyz: Tensor, lidar_type: str, n_scans: int):
    """(ring, ring_ok, ori_raw) of the points xyz [n, 3] (module docstring)."""
    if lidar_type not in LIDAR_CODES:
        raise ValueError(f"unknown lidar_type {lidar_type}")
    return _ring_azimuth_op(xyz.contiguous(), lidar_type, n_scans)


ring_azimuth.launches = 0
_RING_AZIMUTH = ring_azimuth  # keeps the count while a caller swaps the module's name


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


@torch.library.custom_op("scaloam::ring_azimuth", mutates_args=(), device_types="cpu")
def _ring_azimuth_op(xyz: Tensor, lidar_type: str, n_scans: int) -> tuple[Tensor, Tensor, Tensor]:
    return ring_azimuth_plain(xyz, lidar_type, n_scans)


@_ring_azimuth_op.register_kernel("cuda")
def _ring_azimuth_cuda(xyz, lidar_type, n_scans):
    n, dev = xyz.shape[0], xyz.device
    _build.check(xyz, "xyz", torch.float32, (n, 3), dev)
    ring = torch.empty((n,), dtype=torch.int32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    ori = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _build.library("ring_azimuth").scaloam_ring_azimuth
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    err = fn(xyz.data_ptr(), n, LIDAR_CODES[lidar_type], n_scans, ring.data_ptr(), ok.data_ptr(),
             ori.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ring_azimuth: CUDA launch failed with error {err}")
    compiled.count(_RING_AZIMUTH)
    return ring, ok, ori


@_ring_azimuth_op.register_vmap
def _ring_azimuth_vmap(info, in_dims, xyz, lidar_type, n_scans):
    """Elementwise over the points: B scans of n points are B * n points
    of one call."""
    outs = _ring_azimuth_op(_build.fold(xyz, in_dims[0], info.batch_size), lidar_type, n_scans)
    return tuple(_build.unfold(t, info.batch_size) for t in outs), (0, 0, 0)
