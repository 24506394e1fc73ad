"""(The benchmark's reference: a frozen copy of the port's `ops/spatial.py`.)

SO(3) helpers; leading batch dims broadcast.

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
