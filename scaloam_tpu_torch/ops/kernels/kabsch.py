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
kernel and its plain version agree to the bit.
"""

import ctypes

import torch
from torch import Tensor

from scaloam_tpu_torch import compiled
from scaloam_tpu_torch.ops.kernels import _build

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
            root = torch.sqrt(1.0 + zeta * zeta)
            t = torch.where(zeta >= 0, 1.0, -1.0) / (torch.abs(zeta) + root)
            t = torch.where(rot, t, 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
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
    n1 = torch.sqrt(_dot(a1, a1))
    u1 = torch.where((n1 > 0)[:, None], a1 / torch.where(n1 > 0, n1, 1.0)[:, None], eye[0])
    w = a2 - _dot(u1, a2)[:, None] * u1
    m = torch.abs(u1)
    k0 = (m[:, 0] <= m[:, 1]) & (m[:, 0] <= m[:, 2])  # the axis least aligned with u1
    k1 = ~k0 & (m[:, 1] <= m[:, 2])
    e = _pick([eye[0].expand(B, 3), eye[1].expand(B, 3), eye[2].expand(B, 3)], k0, k1)
    e = e - _dot(u1, e)[:, None] * u1
    n2 = torch.sqrt(_dot(w, w))
    w = torch.where((n2 > 0)[:, None], w, e)
    n2 = torch.where(n2 > 0, n2, torch.sqrt(_dot(e, e)))
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
