"""The weighted Kabsch rotation of ICP's alignment step, on the card: a
CUDA kernel (csrc/kabsch.cu) and its plain version, the same algorithm in
PyTorch ops.

Replaces no Pallas kernel. The reference solves each ICP iteration's 3x3
problem with `jnp.linalg.svd` inside its compiled program
(scaloam_tpu/ops/icp.py:122-126, :185-189); on the card
`torch.linalg.svd` reads the device from the host, so no step that calls it
can be captured, and a Jacobi written in plain ops would be some 300
launches a solve.

For H = P^T Q (P the weighted, centred source, Q the centred targets) the
result is R = V diag(1, 1, sign det(V U^T)) U^T with H = U S V^T, the
singular values in LAPACK's descending order. A one-sided (Hestenes)
Jacobi orthogonalises H's columns by plane rotations, a fixed `SWEEPS`
sweeps over the pairs (0, 1), (0, 2), (1, 2): H V = U S, and the
condition number is not squared as a Jacobi on H^T H would square it.
The two columns of largest norm give (u1, s1, v1) and (u2, s2, v2) (ties
to the lower index); u2 is made orthogonal to u1. The sign fix needs no
third pair: det(V U^T) times v3 u3^T is (v1 x v2)(u1 x u2)^T for any
orthonormal U and V, so

    R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T,

which flips the smallest singular direction where det(V U^T) = -1 and is
defined however small s3 is (a near-planar or rank-2 H). H is first
scaled by its largest entry (R does not change), so no square overflows.
Where a column's norm is 0 (H = 0, rank 1) a unit vector stands in:
e_0 for u1, and for u2 the unit axis least aligned with u1, made
orthogonal to it; H = 0 gives the identity, as LAPACK's U = V = I does.

Every step is one IEEE operation in a fixed order (the kernel writes each
with a round-to-nearest intrinsic, so nvcc contracts nothing), so the
kernel and its plain version agree to the bit. The plain version's square
roots are ops/f32.py `sqrt`, correctly rounded as the kernel's
`__fsqrt_rn` (PyTorch's CPU `torch.sqrt` misrounds some inputs by an
ulp), so it gives the kernel's bits on the CPU too.
"""

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops import f32, se3
from scaloam_tpu_torch.ops.kernels import _build
from scaloam_tpu_torch.types import Pose

SWEEPS = 6  # Jacobi sweeps of three rotations each
_PAIRS = ((0, 1), (0, 2), (1, 2))


def kabsch_rotation(H: Tensor) -> Tensor:
    """[..., 3, 3] float32 H = P^T Q -> the proper rotation R [..., 3, 3]
    that best maps P's rows onto Q's (see the module docstring)."""
    return _kabsch_op(H.reshape(-1, 3, 3).contiguous()).reshape(H.shape)


kabsch_rotation.launches = 0
_KABSCH = kabsch_rotation  # keeps the count while a caller swaps the module's name


def _dot(a, b):
    """a . b over the last axis of 3, as ((a0 b0 + a1 b1) + a2 b2)."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _pick(cols, first, second):
    """cols[k] [B, 3] where `first` (k = 0), `second` (k = 1), else k = 2."""
    return torch.where(first[:, None], cols[0], torch.where(second[:, None], cols[1], cols[2]))


def kabsch_plain(H: Tensor) -> Tensor:
    """The kernel's algorithm in PyTorch ops: [B, 3, 3] -> [B, 3, 3]."""
    B = H.shape[0]
    s = torch.amax(torch.abs(H.reshape(B, 9)), dim=1)
    A = H / torch.where(s > 0, s, 1.0)[:, None, None]
    a = [A[:, :, k] for k in range(3)]  # columns of H V
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    v = [eye[k].expand(B, 3) for k in range(3)]  # columns of V
    for _ in range(SWEEPS):
        for p, q in _PAIRS:
            alpha, beta, gamma = _dot(a[p], a[p]), _dot(a[q], a[q]), _dot(a[p], a[q])
            rot = gamma != 0
            zeta = (beta - alpha) / (2.0 * torch.where(rot, gamma, 1.0))
            root = f32.sqrt(1.0 + zeta * zeta)
            t = torch.where(zeta >= 0, 1.0, -1.0) / (torch.abs(zeta) + root)
            t = torch.where(rot, t, 0.0)
            c = 1.0 / f32.sqrt(1.0 + t * t)
            sn = (c * t)[:, None]
            c = c[:, None]
            a[p], a[q] = c * a[p] - sn * a[q], sn * a[p] + c * a[q]
            v[p], v[q] = c * v[p] - sn * v[q], sn * v[p] + c * v[q]
    n = [_dot(x, x) for x in a]
    i0 = (n[0] >= n[1]) & (n[0] >= n[2])  # the largest column, ties to the lower index
    i1 = ~i0 & (n[1] >= n[2])
    i2 = ~i0 & ~i1
    j0 = (i1 & (n[0] >= n[2])) | (i2 & (n[0] >= n[1]))  # the second largest
    j1 = (i0 & (n[1] >= n[2])) | (i2 & (n[0] < n[1]))
    a1, a2 = _pick(a, i0, i1), _pick(a, j0, j1)
    v1, v2 = _pick(v, i0, i1), _pick(v, j0, j1)
    n1 = f32.sqrt(_dot(a1, a1))
    u1 = torch.where((n1 > 0)[:, None], a1 / torch.where(n1 > 0, n1, 1.0)[:, None], eye[0])
    w = a2 - _dot(u1, a2)[:, None] * u1
    m = torch.abs(u1)
    k0 = (m[:, 0] <= m[:, 1]) & (m[:, 0] <= m[:, 2])  # the axis least aligned with u1
    k1 = ~k0 & (m[:, 1] <= m[:, 2])
    e = _pick([eye[0].expand(B, 3), eye[1].expand(B, 3), eye[2].expand(B, 3)], k0, k1)
    e = e - _dot(u1, e)[:, None] * u1
    n2 = f32.sqrt(_dot(w, w))
    w = torch.where((n2 > 0)[:, None], w, e)
    n2 = torch.where(n2 > 0, n2, f32.sqrt(_dot(e, e)))
    u2 = w / n2[:, None]
    v3, u3 = _cross(v1, v2), _cross(u1, u2)
    return ((v1[:, :, None] * u1[:, None, :] + v2[:, :, None] * u2[:, None, :])
            + v3[:, :, None] * u3[:, None, :])


@torch.library.custom_op("scaloam::kabsch", mutates_args=(), device_types="cpu")
def _kabsch_op(H: Tensor) -> Tensor:
    return kabsch_plain(H)


@_kabsch_op.register_kernel("cuda")
def _kabsch_cuda(H):
    B = H.shape[0]
    _build.check(H, "H", torch.float32, (B, 3, 3), H.device)
    out = torch.empty_like(H)
    if B == 0:
        return out
    fn = _build.library("kabsch").scaloam_kabsch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(H.data_ptr(), B, out.data_ptr(), torch.cuda.current_stream(H.device).cuda_stream)
    if err:
        raise RuntimeError(f"kabsch: CUDA launch failed with error {err}")
    compiled.count(_KABSCH)
    return out


@_kabsch_op.register_vmap
def _kabsch_vmap(info, in_dims, H):
    """One matrix a thread: the vmap batch folds into the matrices' axis."""
    return _build.unfold(_kabsch_op(_build.fold(H, in_dims[0], info.batch_size)),
                         info.batch_size), 0


# ---------------------------------------------------------------- the step
#
# One weighted-Kabsch step of ICP in one launch (csrc/kabsch_step.cu): the
# weighted centroids, H = P^T Q, the rotation above, t = mu_t - R mu_s and
# the quaternion, for every batch row. Replaces the ~40 launches an ICP
# iteration of the sums, divisions, matmul, rotation and se3.mat_to_quat
# around `kabsch_rotation` (the reference's scaloam_tpu/ops/icp.py:113-126).
# Every sum runs in one stated tree, the kernel's (`step_layout`): a batch
# row's points in C consecutive slices of K * STEP_THREADS (one block of a
# thread-block cluster each); a thread's partial from 0 over the points i,
# i + STEP_THREADS, ... of its slice; a warp's 32 partials by an xor
# butterfly; a block's 8 warp sums in order; the C block sums in order.

STEP_THREADS = 256  # csrc/kabsch_step.cu kThreads
STEP_MAX_CLUSTER = 8  # the portable cluster size
STEP_MAX_SMEM = 200 * 1024  # of the block's 227 KB, at 28 bytes a point


def step_layout(S: int):
    """(C blocks a batch row, K points a thread) for S points."""
    C = max(1, min(STEP_MAX_CLUSTER, -(-S // STEP_THREADS)))
    K = max(1, -(-S // (C * STEP_THREADS)))
    if K * STEP_THREADS * 28 > STEP_MAX_SMEM:
        raise ValueError(f"kabsch_step: {S} points do not fit the cluster's shared memory")
    return C, K


def kabsch_step(source: Tensor, w: Tensor, tgt: Tensor, mask_q: bool) -> Pose:
    """Weighted Kabsch per batch row: source [S, 3], w [B, S] (weights,
    0 or more), tgt [B, S, 3] -> the pose [B] moving source onto the
    targets; with mask_q the rows of weight 0 leave Q (see above)."""
    quat, trans = _kabsch_step_op(source[None].contiguous(), w.contiguous(), tgt.contiguous(),
                                  bool(mask_q))
    return Pose(quat, trans)


kabsch_step.launches = 0
_STEP = kabsch_step  # keeps the count while a caller swaps the module's name


def _tree_sum(x: Tensor, C: int, K: int) -> Tensor:
    """x [B, S, Q] summed over S in the kernel's tree -> [B, Q]."""
    B, S, Q = x.shape
    T = STEP_THREADS
    x = torch.cat([x, x.new_zeros((B, C * K * T - S, Q))], dim=1).reshape(B, C, K, T, Q)
    acc = torch.zeros_like(x[:, :, 0])  # [B, C, T, Q]: a thread's partial from 0
    for k in range(K):
        acc = acc + x[:, :, k]
    acc = acc.reshape(B, C, T // 32, 32, Q)
    h = 16
    while h:  # the xor butterfly: lane i + lane i ^ h, the lower half kept
        acc = acc[:, :, :, :h] + acc[:, :, :, h:2 * h]
        h //= 2
    acc = acc[:, :, :, 0]  # [B, C, warps, Q]
    block = acc[:, :, 0]
    for wi in range(1, acc.shape[2]):
        block = block + acc[:, :, wi]
    tot = block[:, 0]
    for r in range(1, C):
        tot = tot + block[:, r]
    return tot


def kabsch_step_parts(source: Tensor, w: Tensor, tgt: Tensor, mask_q: bool):
    """The plain step's (mu_s, mu_t, H): source [Bs, S, 3] (Bs 1 or B)."""
    C, K = step_layout(w.shape[1])
    we = w[..., None]
    sums = _tree_sum(torch.cat([we, source * we, tgt * we], dim=-1), C, K)
    wsum = torch.clamp(sums[:, :1], min=1.0)
    mu_s, mu_t = sums[:, 1:4] / wsum, sums[:, 4:7] / wsum
    P = (source - mu_s[:, None]) * we
    Q = tgt - mu_t[:, None]
    if mask_q:
        Q = torch.where(we > 0, Q, 0.0)
    H = _tree_sum((P[..., :, None] * Q[..., None, :]).flatten(-2), C, K).reshape(-1, 3, 3)
    return mu_s, mu_t, H


def kabsch_step_plain(source: Tensor, w: Tensor, tgt: Tensor, mask_q: bool):
    """The kernel's arithmetic in PyTorch ops -> (quat [B, 4], trans [B, 3])."""
    mu_s, mu_t, H = kabsch_step_parts(source, w, tgt, mask_q)
    R = kabsch_plain(H)
    Rmu = (R[:, :, 0] * mu_s[:, 0:1] + R[:, :, 1] * mu_s[:, 1:2]) + R[:, :, 2] * mu_s[:, 2:3]
    return se3.mat_to_quat(R, f32.sqrt), mu_t - Rmu


@torch.library.custom_op("scaloam::kabsch_step", mutates_args=(), device_types="cpu")
def _kabsch_step_op(source: Tensor, w: Tensor, tgt: Tensor,
                    mask_q: bool) -> Tuple[Tensor, Tensor]:
    return kabsch_step_plain(source, w, tgt, mask_q)


@_kabsch_step_op.register_kernel("cuda")
def _kabsch_step_cuda(source, w, tgt, mask_q):
    B, S = w.shape
    Bs, dev = source.shape[0], w.device
    if Bs not in (1, B):
        raise ValueError(f"kabsch_step: {Bs} sources for {B} rows")
    _build.check(source, "source", torch.float32, (Bs, S, 3), dev)
    _build.check(w, "w", torch.float32, (B, S), dev)
    _build.check(tgt, "tgt", torch.float32, (B, S, 3), dev)
    quat = torch.empty((B, 4), dtype=torch.float32, device=dev)
    trans = torch.empty((B, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return quat, trans
    C, K = step_layout(S)
    fn = _build.library("kabsch_step").scaloam_kabsch_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    err = fn(source.data_ptr(), 0 if Bs == 1 else 3 * S, w.data_ptr(), tgt.data_ptr(), B, S,
             C, K, int(mask_q), quat.data_ptr(), trans.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"kabsch_step: CUDA launch failed with error {err}")
    compiled.count(_STEP)
    return quat, trans


@_kabsch_step_op.register_vmap
def _kabsch_step_vmap(info, in_dims, source, w, tgt, mask_q):
    """A cluster a row: the vmap batch folds into the rows' axis; a source
    that differs across the vmap batch is repeated for each of its rows."""
    V = info.batch_size
    w, tgt = _build.fold(w, in_dims[1], V), _build.fold(tgt, in_dims[2], V)
    if in_dims[0] is None:
        if source.shape[0] != 1:
            source = _build.fold(source, None, V)
    else:
        source = source.movedim(in_dims[0], 0)
        source = source.expand(V, w.shape[0] // V, *source.shape[2:])
        source = source.reshape(w.shape[0], *source.shape[2:]).contiguous()
    quat, trans = _kabsch_step_op(source, w, tgt, mask_q)
    return (_build.unfold(quat, V), _build.unfold(trans, V)), (0, 0)
