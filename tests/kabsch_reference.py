"""A float64 weighted Kabsch (numpy only, no JAX), the reference that ICP's
fused step (scaloam_tpu_torch/ops/kernels/kabsch.py `kabsch_step`) is held
to on the CPU (tests/test_torch_fused_kernels.py) and on the card
(tests/test_torch_cuda.py), with the tolerances both use: the quaternion
within 1e-5, the translation within 1e-4 m over clouds of ~10 m.
"""

import numpy as np

F64_Q_TOL, F64_T_TOL = 1e-5, 1e-4


def f64_kabsch(src, w, tgt, mask_q):
    """The same weighted Kabsch in float64: numpy's SVD, det sign fix.
    src [S, 3], w [S], tgt [S, 3] -> (R [3, 3], t [3])."""
    src, w, tgt = src.astype(np.float64), w.astype(np.float64), tgt.astype(np.float64)
    wsum = max(w.sum(), 1.0)
    mu_s, mu_t = (src * w[:, None]).sum(0) / wsum, (tgt * w[:, None]).sum(0) / wsum
    P, Q = (src - mu_s) * w[:, None], tgt - mu_t
    if mask_q:
        Q = np.where(w[:, None] > 0, Q, 0.0)
    U, _, Vt = np.linalg.svd(P.T @ Q)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return R, mu_t - R @ mu_s


def quat_err(got, want):
    """Largest entry of |got - want| over quaternions [..., 4], each pair
    compared with want's sign flipped where it points the other way."""
    got, want = np.asarray(got).reshape(-1, 4), np.asarray(want).reshape(-1, 4)
    sign = np.where(np.sum(got * want, -1, keepdims=True) < 0, -1.0, 1.0)
    return np.abs(got * sign - want).max()
