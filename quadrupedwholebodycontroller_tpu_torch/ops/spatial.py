"""SO(3) helpers; leading batch dims broadcast.

Conventions match the reference controller: skew as its cross-product
matrix, RPY extraction as its eulAnglesRPY (roll = atan2(R21, R22),
pitch = atan2(-R20, sqrt(R21^2 + R22^2)), yaw = atan2(R10, R00)).
"""
from __future__ import annotations

import torch


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rpy_to_matrix(rpy):
    """(..., 3) roll-pitch-yaw -> (..., 3, 3) rotation, R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_rpy(R):
    """(..., 3, 3) -> (..., 3) RPY, exactly the reference's eulAnglesRPY."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.atan2(
        -R[..., 2, 0],
        torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2),
    )
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def axis_angle_to_matrix(axis, angle):
    """Rodrigues rotation about a (fixed, unit) axis.

    axis: (..., 3); angle: (...) -> (..., 3, 3); the two broadcast."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def quat_to_matrix(q):
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / (w * w + x * x + y * y + z * z)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    row0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(R):
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), branchless: each
    component's magnitude from the diagonal, its sign from the skew part."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    half_sqrt = lambda v: torch.sqrt(torch.clamp_min(v, 1e-12)) / 2.0
    qw = half_sqrt(1.0 + m00 + m11 + m22)
    qx = torch.copysign(half_sqrt(1.0 + m00 - m11 - m22), R[..., 2, 1] - R[..., 1, 2])
    qy = torch.copysign(half_sqrt(1.0 - m00 + m11 - m22), R[..., 0, 2] - R[..., 2, 0])
    qz = torch.copysign(half_sqrt(1.0 - m00 - m11 + m22), R[..., 1, 0] - R[..., 0, 1])
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def orthonormalize(R):
    """Project a near-rotation matrix back onto SO(3) by Gram-Schmidt on its
    first two columns (the integrator keeps the base rotation on the
    manifold with it, without an SVD)."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y)
    return torch.stack([x, y, z], dim=-1)
