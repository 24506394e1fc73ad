"""(The benchmark's reference: a frozen copy of the port's `ops/centroidal.py`.)

Centroidal-coordinates transformation, batched.

Replicates the reference's computeTransformationMatrix and the centroidal
projections of its updateState.  T is block upper-triangular with an
SE(3)-adjoint top-left block, so no generic 18x18 inversion is needed.

The transform maps the mixed generalized velocity u = [v_base; omega; qdot]
to [v_avg_com (6); qdot]; the transformed mass matrix is block-diagonal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import spatial
from benchmark.reference.linalg import spd_inv6


class CentroidalTransform(NamedTuple):
    T: torch.Tensor      # (..., nv, nv)
    T_inv: torch.Tensor  # (..., nv, nv)


def centroidal_transform(M, com, base_p) -> CentroidalTransform:
    """Build T and its exact inverse from the mass matrix.

      Adj     = [[I, skew(c - p_b)], [0, I]]
      AdjInv  = Adj with the skew block negated
      J_com   = AdjInv @ Mb^{-1} @ [Mb | Mbj]  =  [AdjInv | AdjInv Mb^{-1} Mbj]
      T       = [[J_com], [0, I_nj]]
      T^{-1}  = [[Adj, -Mb^{-1} Mbj], [0, I_nj]]   (block-triangular inverse)

    Mb^{-1} is the closed-form 3x3-block Schur inverse plus one refinement
    pass, on every device (exact to rounding, no factorization call)."""
    nv = M.shape[-1]
    nj = nv - 6
    batch = M.shape[:-2]
    kw = dict(dtype=M.dtype, device=M.device)
    S = spatial.skew(com - base_p)
    eye3 = torch.eye(3, **kw).expand(batch + (3, 3))
    zero3 = torch.zeros(batch + (3, 3), **kw)
    adj = torch.cat(
        [torch.cat([eye3, S], dim=-1), torch.cat([zero3, eye3], dim=-1)], dim=-2
    )
    adj_inv = torch.cat(
        [torch.cat([eye3, -S], dim=-1), torch.cat([zero3, eye3], dim=-1)], dim=-2
    )

    Mb = M[..., :6, :6]
    Mbj = M[..., :6, 6:]
    Mb_inv = spd_inv6(Mb)
    X = Mb_inv @ Mbj                          # Mb^{-1} Mbj  (..., 6, nj)
    X = X + Mb_inv @ (Mbj - Mb @ X)
    B = adj_inv @ X                           # top-right block of T

    eye_j = torch.eye(nj, **kw).expand(batch + (nj, nj))
    zero_j6 = torch.zeros(batch + (nj, 6), **kw)
    bottom = torch.cat([zero_j6, eye_j], dim=-1)
    T = torch.cat([torch.cat([adj_inv, B], dim=-1), bottom], dim=-2)
    T_inv = torch.cat([torch.cat([adj, -X], dim=-1), bottom], dim=-2)
    return CentroidalTransform(T=T, T_inv=T_inv)


def centroidal_mass_matrix(M, tf: CentroidalTransform):
    """M_c = T^{-T} M T^{-1}."""
    return tf.T_inv.transpose(-1, -2) @ M @ tf.T_inv


def project_jacobian(J, tf: CentroidalTransform):
    """J_c = J @ T^{-1}."""
    return J @ tf.T_inv


def centroidal_bias(h_coriolis, M, tdot_inv, u, tf: CentroidalTransform):
    """h_c = T^{-T} (h_C + M @ d(T^{-1})/dt @ u).

    tdot_inv is d(T^{-1})/dt; in the reference-faithful controller it is
    the one-cycle-stale finite-difference value carried across steps."""
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    return mv(tf.T_inv.transpose(-1, -2), h_coriolis + mv(M, mv(tdot_inv, u)))


def tdot_inverse(tf: CentroidalTransform, T_dot):
    """d(T^{-1})/dt = -T^{-1} Tdot T^{-1}."""
    return -tf.T_inv @ T_dot @ tf.T_inv
