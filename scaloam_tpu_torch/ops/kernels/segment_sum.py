"""Scatter-adds in one fixed order, on the card: a CUDA kernel
(csrc/segment_sum.cu) and its plain version.

`add(base, rows, plan)` is `base.index_add(0, index, rows)` with the rows
of each index added one after another in ascending row order, the order
of the reference's `.at[index].add(rows)`. On the card PyTorch's
index_add_ sums colliding rows with float atomics, in a new order each
run, so an optimise whose loops share a pose-graph node would give a new
answer each run. `plan(index, n)` sorts the rows once by a stable sort of
their index (the pose graph's loop ends do not change within an
optimise); the kernel then walks each segment's rows in that order, one
thread a (segment, component), nothing atomic. The plain version takes
one row of every segment a step, in the same order, so the two agree bit
for bit. Replaces no Pallas kernel.
"""

import ctypes
import math
from typing import NamedTuple

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops.kernels import _build


class Plan(NamedTuple):
    order: Tensor  # [R] int64: the rows by a stable sort of their index
    starts: Tensor  # [n + 1] int64: segment k is order[starts[k]:starts[k + 1]]


def plan(index: Tensor, n: int) -> Plan:
    """The sort of rows by `index` that `add` walks: segment k holds the
    rows whose index is k; a row whose index is n or more (a padding slot,
    whose row is zero) belongs to no segment and is left out."""
    index = index.to(torch.int64)
    order = torch.sort(index, stable=True).indices
    bounds = torch.arange(n + 1, dtype=torch.int64, device=index.device)
    return Plan(order, torch.searchsorted(index[order], bounds))


def add(base: Tensor, rows: Tensor, p: Plan) -> Tensor:
    """base [n, ...] + the rows [R, ...] of each segment of `p`, in
    ascending row order, as a new tensor."""
    out = _segment_sum_op(_rows(base).contiguous(), _rows(rows).contiguous(), p.order, p.starts)
    return out.reshape(base.shape)


add.launches = 0
_ADD = add  # keeps the count while a caller swaps the module's name


def _rows(t: Tensor) -> Tensor:
    """t [R, ...] as [R, C] (R may be 0)."""
    return t.reshape(t.shape[0], math.prod(t.shape[1:]))


def add_plain(base: Tensor, rows: Tensor, order: Tensor, starts: Tensor) -> Tensor:
    """The kernel's sums in PyTorch ops: step k adds the k-th row of every
    segment that has one."""
    n = base.shape[0]
    first, count = starts[:-1], starts[1:] - starts[:-1]
    out, rows = _rows(base), _rows(rows)
    depth = int(count.max()) if n else 0  # a host read: this runs on the CPU
    for k in range(depth):
        r = order[torch.clamp(first + k, max=max(order.shape[0] - 1, 0))]
        out = torch.where((k < count)[:, None], out + rows[r], out)
    return out.reshape(base.shape).clone()


@torch.library.custom_op("scaloam::segment_sum", mutates_args=(), device_types="cpu")
def _segment_sum_op(base: Tensor, rows: Tensor, order: Tensor, starts: Tensor) -> Tensor:
    return add_plain(base, rows, order, starts)


@_segment_sum_op.register_kernel("cuda")
def _segment_sum_cuda(base, rows, order, starts):
    n, c = base.shape
    R, dev = rows.shape[0], base.device
    _build.check(base, "base", torch.float32, (n, c), dev)
    _build.check(rows, "rows", torch.float32, (R, c), dev)
    _build.check(order, "order", torch.int64, (R,), dev)
    _build.check(starts, "starts", torch.int64, (n + 1,), dev)
    out = torch.empty_like(base)
    if n * c == 0:
        return out
    fn = _build.library("segment_sum").scaloam_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
    err = fn(base.data_ptr(), rows.data_ptr(), order.data_ptr(), starts.data_ptr(), n, c,
             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment_sum: CUDA launch failed with error {err}")
    compiled.count(_ADD)
    return out
