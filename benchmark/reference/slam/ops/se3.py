"""SO(3)/SE(3) operations on (wxyz quaternion, translation) pairs
(counterpart of scaloam_tpu/ops/se3.py).

Every function broadcasts over leading axes. Small reductions are written
out term by term, in the order the reference's XLA reductions add them.
"""

from __future__ import annotations

import torch

from reference.slam.types import Pose

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


def quat_normalize(q: torch.Tensor, sqrt=torch.sqrt) -> torch.Tensor:
    return q / torch.clamp(sqrt(sq_norm(q)), min=_EPS)[..., None]


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


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, s) -> torch.Tensor:
    """Spherical interpolation from q0 towards q1 by fraction s (a number
    or a tensor broadcasting against [..., 1]): Eigen's slerp, which the
    reference's motion de-skew uses (src/laserOdometry.cpp:122)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / safe)
    w1 = torch.where(small, s * torch.ones_like(theta), torch.sin(s * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


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


def quat_to_rpy(q: torch.Tensor):
    """Returns (roll, pitch, yaw) of R = Rz(yaw) Ry(pitch) Rx(roll)."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw
