"""Greedy curvature feature selection: CUDA kernel K1 and its plain version.

Replaces the TPU kernel scaloam_tpu/ops/pallas/selection.py:select_features.
The kernel is csrc/selection.cu (one thread block per ring row, the row in
shared memory; each subregion's candidates sorted once, then one warp walks
the sorted lists with ballots); what bounds it on the card and what its
design does about that is noted there. `select_features` calls the
custom op `scaloam::select_features`, which launches the kernel for CUDA
tensors and runs `select_features_plain`, a literal PyTorch transcription
of the Pallas kernel body, for CPU tensors. The op's vmap rule folds a
batch of frames into rows, so a batch of B frames is one launch over
B x S rows, as the Pallas kernel under jax.vmap is one call with a
leading grid axis.
"""

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from scaloam_tpu_torch.ops.kernels import _build

NEG = -1e30
_SMEM_LIMIT = 227 * 1024  # opt-in shared memory per block on Hopper
_MAX_W = 32767  # the kernel's sorted lists hold int16 indices
_MAX_SUB = 8
_MAX_ROUNDS = 32  # the kernel keeps round p's pick in lane p


def select_features(curv, left_ext, right_ext, eligible, sp, ep, n_sub: int,
                    n_corner: int, n_flat: int, curv_thr: float):
    """curv f32 [S, W], left/right_ext int32 [S, W], eligible bool [S, W],
    sp/ep int32 [S, n_sub]. Returns (corner_idx int32 [S, n_sub, n_corner],
    corner_ok bool, flat_idx int32 [S, n_sub, n_flat], flat_ok bool,
    labels bool [S, W]). Under torch.func.vmap the batch folds into the
    rows: one launch for [B, S, W]."""
    return tuple(_select_op(curv, left_ext, right_ext, eligible, sp, ep, n_sub,
                            n_corner, n_flat, float(curv_thr)))


select_features.launches = 0
_SELECT = select_features  # keeps the count while a caller swaps the module's name


@torch.library.custom_op("scaloam::select_features", mutates_args=(), device_types="cpu")
def _select_op(curv: Tensor, left_ext: Tensor, right_ext: Tensor, eligible: Tensor,
               sp: Tensor, ep: Tensor, n_sub: int, n_corner: int, n_flat: int,
               curv_thr: float) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return select_features_plain(curv, left_ext, right_ext, eligible, sp, ep,
                                 n_sub, n_corner, n_flat, curv_thr)


@_select_op.register_kernel("cuda")
def _select_cuda(curv, left_ext, right_ext, eligible, sp, ep, n_sub, n_corner, n_flat,
                 curv_thr):
    S, W = curv.shape
    dev = curv.device
    _build.check(curv, "curv", torch.float32, (S, W), dev)
    _build.check(left_ext, "left_ext", torch.int32, (S, W), dev)
    _build.check(right_ext, "right_ext", torch.int32, (S, W), dev)
    _build.check(eligible, "eligible", torch.bool, (S, W), dev)
    _build.check(sp, "sp", torch.int32, (S, n_sub), dev)
    _build.check(ep, "ep", torch.int32, (S, n_sub), dev)
    if (W > _MAX_W or not 1 <= n_sub <= _MAX_SUB or not abs(curv_thr) < 1e30
            or max(n_corner, n_flat) > _MAX_ROUNDS):
        raise ValueError(f"select_features: W {W} (max {_MAX_W}), n_sub {n_sub} "
                         f"(1..{_MAX_SUB}), rounds {n_corner}/{n_flat} (max {_MAX_ROUNDS}) "
                         f"or curv_thr {curv_thr} out of range")
    lib = _build.library("selection")
    smem_fn = lib.scaloam_select_features_smem
    smem_fn.restype = ctypes.c_size_t
    smem_fn.argtypes = [ctypes.c_int] * 4
    if smem_fn(W, n_sub, n_corner, n_flat) > _SMEM_LIMIT - 1024:
        raise ValueError(f"select_features: row width {W} does not fit in shared memory")
    ci = torch.empty((S, n_sub, n_corner), dtype=torch.int32, device=dev)
    co = torch.empty((S, n_sub, n_corner), dtype=torch.bool, device=dev)
    fi = torch.empty((S, n_sub, n_flat), dtype=torch.int32, device=dev)
    fo = torch.empty((S, n_sub, n_flat), dtype=torch.bool, device=dev)
    labels = torch.empty((S, W), dtype=torch.bool, device=dev)
    fn = lib.scaloam_select_features
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 6
    err = fn(
        curv.data_ptr(), left_ext.data_ptr(), right_ext.data_ptr(),
        eligible.data_ptr(), sp.data_ptr(), ep.data_ptr(),
        S, W, n_sub, n_corner, n_flat, float(curv_thr),
        ci.data_ptr(), co.data_ptr(), fi.data_ptr(), fo.data_ptr(),
        labels.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"select_features: CUDA launch failed with error {err}")
    _SELECT.launches += 1
    return ci, co, fi, fo, labels


@_select_op.register_vmap
def _select_vmap(info, in_dims, curv, left_ext, right_ext, eligible, sp, ep, n_sub,
                 n_corner, n_flat, curv_thr):
    """Rows are independent (one block each): [B, S, ...] folds into
    [B * S, ...] rows of one call."""
    rows = [_build.fold(t, d, info.batch_size)
            for t, d in zip((curv, left_ext, right_ext, eligible, sp, ep), in_dims)]
    outs = _select_op(*rows, n_sub, n_corner, n_flat, curv_thr)
    return tuple(_build.unfold(o, info.batch_size) for o in outs), (0,) * len(outs)


def select_features_plain(curv, left_ext, right_ext, eligible, sp, ep,
                          n_sub: int, n_corner: int, n_flat: int,
                          curv_thr: float):
    """The Pallas kernel body (selection.py:_make_kernel) in PyTorch, on
    whole [S, W] rows at a time."""
    S, W = curv.shape
    dev = curv.device
    jj = torch.arange(W, device=dev)[None, :].expand(S, W)
    elig = eligible.bool()
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    sup = torch.zeros((S, W), dtype=torch.bool, device=dev)
    labels = torch.zeros((S, W), dtype=torch.bool, device=dev)
    ci = torch.zeros((S, n_sub, n_corner), dtype=torch.int32, device=dev)
    co = torch.zeros((S, n_sub, n_corner), dtype=torch.bool, device=dev)
    fi = torch.zeros((S, n_sub, n_flat), dtype=torch.int32, device=dev)
    fo = torch.zeros((S, n_sub, n_flat), dtype=torch.bool, device=dev)

    def pick(s, val):
        """Masked argmax in subregion s: (jstar [S], found [S], band [S, W])."""
        sub = (jj >= sp[:, s, None]) & (jj <= ep[:, s, None])
        v = torch.where(sub, val, neg)
        m = torch.amax(v, dim=1)
        found = m > neg
        is_max = (v == m[:, None]) & found[:, None]
        jstar = torch.amin(torch.where(is_max, jj, W), dim=1)
        jstar_c = torch.where(found, jstar, 0)
        onehot = jj == jstar_c[:, None]
        lext = torch.amax(torch.where(onehot, left_ext, 0), dim=1)
        rext = torch.amax(torch.where(onehot, right_ext, 0), dim=1)
        lo = torch.where(found, jstar_c - lext, -1)
        hi = torch.where(found, jstar_c + rext, -1)
        band = (jj >= lo[:, None]) & (jj <= hi[:, None])
        return jstar_c, found, band

    for p in range(n_corner):
        val = torch.where(elig & ~sup & (curv > curv_thr), curv, neg)
        for s in range(n_sub):
            jstar, found, band = pick(s, val)
            sup = sup | band
            labels = labels | ((jj == jstar[:, None]) & found[:, None])
            ci[:, s, p] = jstar.to(torch.int32)
            co[:, s, p] = found
            val = torch.where(band, neg, val)

    for p in range(n_flat):
        val = torch.where(elig & ~sup & (curv < curv_thr), -curv, neg)
        for s in range(n_sub):
            jstar, found, band = pick(s, val)
            if p < n_flat - 1:
                # the last flat pick breaks before suppressing
                sup = sup | band
                val = torch.where(band, neg, val)
            fi[:, s, p] = jstar.to(torch.int32)
            fo[:, s, p] = found
    return ci, co, fi, fo, labels
