"""Odometry's 2-NN sweep of a query cloud against a target cloud in one
launch on the card: a CUDA kernel (csrc/sweep_top2.cu) and its plain
version, the port's former composition.

`sweep_top2(query [Q, 3], target [T, 3], target_mask [T], target_ring [T],
nearby, want_same, tile_any, tile_ring)` returns

    idx  int64 [C, Q, 2]     the two nearest targets of each query a class,
                             -1 where no tile filled the slot
    pts  f32   [C, Q, 2, 3]  their points, zero rows for -1

for the C = 2 + want_same classes: any target that passes the mask (ranked
over tiles of tile_any), then, from the any-class 1-NN's ring and index,
(the same ring without that index,) and another ring within `nearby` (over
tiles of tile_ring). Ranks and ties are voxel.knn2_payload's and
correspond.ring_constrained_nn2_pts's: the tile sizes are part of the
result, so each is fitted to T as those functions fit it. The query mask
plays no part: it masks only distances, which the odometry does not read.

Replaces no Pallas kernel. On the card each tile of the former composition
wrote its whole [Q, tile] distance block (csrc/f32ops.cu's sq_dist) and ran
a dozen plain ops over it; the kernel keeps distances, masks and the running
top-2s in registers. Under torch.func.vmap the batch folds into one launch.
"""

import ctypes

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops import correspond, voxel
from scaloam_tpu_torch.ops.kernels import _build

_LANES = (8, 16, 32)  # lanes a query the kernel takes
_THREADS_PER_SM = 256  # threads to keep in flight on each SM before lanes are added


def sweep_top2(query: Tensor, target: Tensor, target_mask: Tensor, target_ring: Tensor,
               nearby: float, want_same: bool, tile_any: int, tile_ring: int):
    """(idx, pts) of the two nearest targets a class (module docstring)."""
    T = target.shape[0]
    idx, pts = _sweep_op(query.contiguous()[None], target.contiguous()[None],
                         target_mask.contiguous()[None], target_ring.contiguous()[None],
                         float(nearby), bool(want_same), voxel.fit_tile(T, tile_any),
                         voxel.fit_tile(T, tile_ring))
    return idx[0], pts[0]


sweep_top2.launches = 0
_SWEEP = sweep_top2  # keeps the count while a caller swaps the module's name


def sweep_top2_plain(query: Tensor, target: Tensor, target_mask: Tensor, target_ring: Tensor,
                     nearby: float, want_same: bool, tile_any: int, tile_ring: int):
    """The former composition on one problem: knn2_payload's sweep, then
    ring_constrained_nn2_pts's from the 1-NN's payload row (its ring and
    index, 0 and 0 where it has none)."""
    b = voxel.knn2_best(query, target, target_mask, tile_any)
    i_any = torch.stack([b[1], b[3]], dim=1)
    ring_ref = voxel.gather_rows(target_ring[:, None], i_any[:, :1])[:, 0, 0]
    excl = torch.clamp(i_any[:, 0], min=0)
    best_s, best_o = correspond.ring_nn2_best(query, ring_ref, excl, target, target_mask,
                                              target_ring, nearby, tile_ring, want_same)
    rows = [i_any] + [torch.stack([w[1], w[3]], dim=1)
                      for w in ((best_s, best_o) if want_same else (best_o,))]
    idx = torch.stack(rows)
    return idx, voxel.gather_rows(target, idx)


@torch.library.custom_op("scaloam::sweep_top2", mutates_args=(), device_types="cpu")
def _sweep_op(query: Tensor, target: Tensor, target_mask: Tensor, target_ring: Tensor,
              nearby: float, want_same: bool, tile_any: int,
              tile_ring: int) -> tuple[Tensor, Tensor]:
    """P problems (every tensor with a leading [P]): idx [P, C, Q, 2], pts
    [P, C, Q, 2, 3]. On the CPU, the plain version a problem."""
    outs = [sweep_top2_plain(*a, nearby, want_same, tile_any, tile_ring)
            for a in zip(query, target, target_mask, target_ring)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _lanes(problems: int, device) -> int:
    """The fewest lanes a query that keep _THREADS_PER_SM threads on every
    SM, else the most."""
    want = torch.cuda.get_device_properties(device).multi_processor_count * _THREADS_PER_SM
    return next((n for n in _LANES if problems * n >= want), _LANES[-1])


@_sweep_op.register_kernel("cuda")
def _sweep_cuda(query, target, target_mask, target_ring, nearby, want_same, tile_any, tile_ring):
    B, Q, T = query.shape[0], query.shape[1], target.shape[1]
    dev = query.device
    f32 = torch.float32
    _build.check(query, "query", f32, (B, Q, 3), dev)
    _build.check(target, "target", f32, (B, T, 3), dev)
    _build.check(target_mask, "target_mask", torch.bool, (B, T), dev)
    _build.check(target_ring, "target_ring", f32, (B, T), dev)
    if B > 65535 or T >= 2**30:
        raise ValueError(f"sweep_top2: {B} problems of {T} targets exceed the kernel's grid")
    for name, tile in (("tile_any", tile_any), ("tile_ring", tile_ring)):
        if tile <= 0 or T % tile:
            raise ValueError(f"sweep_top2: {name} {tile} does not divide {T} targets")
    C = 2 + bool(want_same)
    idx = torch.empty((B, C, Q, 2), dtype=torch.int64, device=dev)
    pts = torch.empty((B, C, Q, 2, 3), dtype=f32, device=dev)
    fn = _build.library("sweep_top2").scaloam_sweep_top2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    err = fn(query.data_ptr(), target.data_ptr(), target_mask.data_ptr(), target_ring.data_ptr(),
             B, Q, T, tile_any, tile_ring, nearby, int(want_same), _lanes(B * Q, dev),
             idx.data_ptr(), pts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sweep_top2: CUDA launch failed with error {err}")
    compiled.count(_SWEEP)
    return idx, pts


@_sweep_op.register_vmap
def _sweep_vmap(info, in_dims, query, target, target_mask, target_ring, nearby, want_same,
                tile_any, tile_ring):
    """B batches of P problems are B * P problems of one call."""
    folded = [_build.fold(t, d, info.batch_size)
              for t, d in zip((query, target, target_mask, target_ring), in_dims)]
    outs = _sweep_op(*folded, nearby, want_same, tile_any, tile_ring)
    return tuple(_build.unfold(o, info.batch_size) for o in outs), (0, 0)
