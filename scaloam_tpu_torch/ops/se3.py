"""SO(3)/SE(3) operations on (wxyz quaternion, translation) pairs
(counterpart of scaloam_tpu/ops/se3.py).

Every function broadcasts over leading axes. Small reductions are written
out term by term, in the order the reference's XLA reductions add them.
"""

from __future__ import annotations

import torch

from scaloam_tpu_torch.types import Pose

_EPS = 1e-12


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (the jnp.cross formula)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def sq_norm(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, added left to right."""
    parts = v.unbind(-1)
    s = parts[0] * parts[0]
    for p in parts[1:]:
        s = s + p * p
    return s


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.sqrt(sq_norm(q)), min=_EPS)[..., None]


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # Negation is exact, as the reference's multiply by (1, -1, -1, -1) is;
    # no sign tensor is copied from host memory.
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> unit quaternion (wxyz)."""
    t2 = sq_norm(w)[..., None]
    small = t2 < 1e-12
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    half = 0.5 * theta
    # sin(x/2)/x -> 1/2 - x^2/48; cos(x/2) -> 1 - x^2/8 for small x.
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - t2 / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] wxyz by
    Shepperd's method without branches: all four candidate forms, the one
    with the largest pivot kept; the sign is canonical (w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    case = torch.argmax(pivots, dim=-1)  # first of equal pivots
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., case, comp]
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def log_so3(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector [..., 3]; the small-angle branch
    is a select, so autodiff through the identity stays finite."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 branch
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return k * v


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3) at rotation vector w [..., 3] -> [..., 3, 3]."""
    t2_raw = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2_raw < 1e-10
    t2 = torch.where(small, torch.ones_like(t2_raw), t2_raw)
    theta = torch.sqrt(t2)
    W = hat(w)
    W2 = torch.matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    a = torch.where(small, 0.5 - t2_raw / 24.0, (1.0 - torch.cos(theta)) / t2)
    b = torch.where(small, 1.0 / 6.0 - t2_raw / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return eye + a * W + b * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    t2_raw = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2_raw < 1e-10
    t2 = torch.where(small, torch.ones_like(t2_raw), t2_raw)
    theta = torch.sqrt(t2)
    W = hat(w)
    W2 = torch.matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0 / 12.0 + t2_raw / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / t2,
    )
    return eye - 0.5 * W + cot * W2


def exp_se3(xi: torch.Tensor) -> Pose:
    """se(3) tangent [..., 6] (omega, v) -> Pose (GTSAM Logmap ordering)."""
    w, v = xi[..., :3], xi[..., 3:]
    return Pose(exp_so3(w), torch.matmul(_so3_left_jacobian(w), v[..., None])[..., 0])


def log_se3(p: Pose) -> torch.Tensor:
    """Pose -> se(3) tangent [..., 6] (omega, v)."""
    w = log_so3(p.quat)
    v = torch.matmul(_so3_left_jacobian_inv(w), p.trans[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(a: Pose, b: Pose) -> Pose:
    """a then b applied in a's frame: T_a * T_b."""
    return Pose(
        quat_normalize(quat_mul(a.quat, b.quat)),
        quat_rotate(a.quat, b.trans) + a.trans,
    )


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.quat)
    return Pose(qi, -quat_rotate(qi, p.trans))


def apply(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Transform points [..., 3] by pose."""
    return quat_rotate(p.quat, pts) + p.trans


def relative(a: Pose, b: Pose) -> Pose:
    """T_a^-1 * T_b, the between-pose of a BetweenFactor."""
    return compose(inverse(a), b)


def rpy_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll) as a wxyz quaternion."""
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def pose_to_matrix(p: Pose) -> torch.Tensor:
    """Pose -> homogeneous [..., 4, 4]."""
    R = quat_to_mat(p.quat)
    top = torch.cat([R, p.trans[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def matrix_to_pose(m: torch.Tensor) -> Pose:
    return Pose(mat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def quat_to_rpy(q: torch.Tensor):
    """Returns (roll, pitch, yaw) of R = Rz(yaw) Ry(pitch) Rx(roll)."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw
