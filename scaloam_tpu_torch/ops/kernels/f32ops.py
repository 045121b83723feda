"""Float32 arithmetic rounded as the compiled reference rounds it, on the
card: CUDA kernels for the 2-NN squared distances, 3-vector squared norms
and atan2, with their plain versions in scaloam_tpu_torch/ops/f32.py.

The kernels are csrc/f32ops.cu; none replaces a Pallas kernel. They
replace the plain versions' float64 emulation of XLA:CPU's fused
multiply-adds and glibc's atan2f, which on the card are a dozen to sixty
elementwise launches a call and, for the distances, several full [Q, T]
temporaries a tile. `sq_dist`, `sum3_sq` and `atan2` call the custom ops
`scaloam::sq_dist`, `scaloam::sum3_sq` and `scaloam::atan2f`, which
launch the kernel for CUDA tensors and run the plain version for CPU
tensors. Under torch.func.vmap the batch folds into one launch: sq_dist's
kernel takes a leading batch axis, the others are elementwise.
"""

import ctypes

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops import f32
from scaloam_tpu_torch.ops.kernels import _build

_MAX_ROW_BLOCKS = 65535  # the kernel's grid.y: query rows / 8


def sq_dist(query: Tensor, target: Tensor) -> Tensor:
    """[Q, 3] x [T, 3] -> [Q, T] squared distances |q|^2 + |t|^2 - 2 q.t,
    rounded as the reference's compiled program rounds them (f32.sq_dist)."""
    return _sq_dist_op(query.contiguous()[None], target.contiguous()[None])[0]


sq_dist.launches = 0
_SQ_DIST = sq_dist  # keeps the count while a caller swaps the module's name


def sum3_sq(v: Tensor) -> Tensor:
    """Squared norms over the last axis of 3, [..., 3] -> [...], rounded as
    the reference's compiled reduction (f32.sum3_sq)."""
    return _sum3_sq_op(v.contiguous())


sum3_sq.launches = 0
_SUM3_SQ = sum3_sq


def atan2(y: Tensor, x: Tensor) -> Tensor:
    """glibc's atan2f(y, x), elementwise over float32 tensors of one shape
    (f32.atan2)."""
    return _atan2_op(y.contiguous(), x.contiguous())


atan2.launches = 0
_ATAN2 = atan2


@torch.library.custom_op("scaloam::sq_dist", mutates_args=(), device_types="cpu")
def _sq_dist_op(query: Tensor, target: Tensor) -> Tensor:
    return torch.stack([f32.sq_dist(q, t) for q, t in zip(query, target)])


@_sq_dist_op.register_kernel("cuda")
def _sq_dist_cuda(query, target):
    B, Q, T = query.shape[0], query.shape[1], target.shape[1]
    dev = query.device
    _build.check(query, "query", torch.float32, (B, Q, 3), dev)
    _build.check(target, "target", torch.float32, (B, T, 3), dev)
    if (Q + 7) // 8 > _MAX_ROW_BLOCKS or B > 65535:
        raise ValueError(f"sq_dist: {B} x {Q} queries exceed the kernel's grid")
    out = torch.empty((B, Q, T), dtype=torch.float32, device=dev)
    fn = _build.library("f32ops").scaloam_sq_dist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    err = fn(query.data_ptr(), target.data_ptr(), B, Q, T, out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sq_dist: CUDA launch failed with error {err}")
    compiled.count(_SQ_DIST)
    return out


@_sq_dist_op.register_vmap
def _sq_dist_vmap(info, in_dims, query, target):
    """B batches of P problems are B * P problems of one call."""
    outs = _sq_dist_op(*(_build.fold(t, d, info.batch_size)
                         for t, d in zip((query, target), in_dims)))
    return _build.unfold(outs, info.batch_size), 0


@torch.library.custom_op("scaloam::sum3_sq", mutates_args=(), device_types="cpu")
def _sum3_sq_op(v: Tensor) -> Tensor:
    return f32.sum3_sq(v)


@_sum3_sq_op.register_kernel("cuda")
def _sum3_sq_cuda(v):
    _build.check(v, "v", torch.float32, v.shape, v.device)  # dtype, device, layout
    if v.dim() == 0 or v.shape[-1] != 3:
        raise ValueError(f"sum3_sq: want [..., 3], got {tuple(v.shape)}")
    out = torch.empty(v.shape[:-1], dtype=torch.float32, device=v.device)
    fn = _build.library("f32ops").scaloam_sum3_sq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
    err = fn(v.data_ptr(), out.numel(), out.data_ptr(),
             torch.cuda.current_stream(v.device).cuda_stream)
    if err:
        raise RuntimeError(f"sum3_sq: CUDA launch failed with error {err}")
    compiled.count(_SUM3_SQ)
    return out


@_sum3_sq_op.register_vmap
def _sum3_sq_vmap(info, in_dims, v):
    """Elementwise over the leading axes: the batch leading, one call."""
    return _sum3_sq_op(v.movedim(in_dims[0], 0).contiguous()), 0


@torch.library.custom_op("scaloam::atan2f", mutates_args=(), device_types="cpu")
def _atan2_op(y: Tensor, x: Tensor) -> Tensor:
    return f32.atan2(y, x)


@_atan2_op.register_kernel("cuda")
def _atan2_cuda(y, x):
    _build.check(y, "y", torch.float32, y.shape, y.device)  # dtype and device
    _build.check(x, "x", torch.float32, y.shape, y.device)  # and one shape
    out = torch.empty_like(y)
    fn = _build.library("f32ops").scaloam_atan2f
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    err = fn(y.data_ptr(), x.data_ptr(), y.numel(), out.data_ptr(),
             torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"atan2: CUDA launch failed with error {err}")
    compiled.count(_ATAN2)
    return out


@_atan2_op.register_vmap
def _atan2_vmap(info, in_dims, y, x):
    """Elementwise: both arguments with the batch leading, one call."""
    y, x = ((t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape))
            for t, d in zip((y, x), in_dims))
    return _atan2_op(y.contiguous(), x.contiguous()), 0
