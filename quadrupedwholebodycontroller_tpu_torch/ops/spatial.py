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
