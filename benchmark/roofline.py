"""The yardstick of the kernels' roofline shares: published H100 peaks and
the operations and bytes each launch needs, computed from its shapes.

A frozen copy of the arithmetic of `chip_smoke.py` (`flops_of`,
`setup_bytes` and the bytes of the solver kernels: every tensor argument
read once, every output written once), so that a later change to the smoke
cannot move the benchmark's yardstick.  Multiply-adds count 2; matvecs and
matrix products only (the elementwise tails are a few percent).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM device memory rate (data sheet, 700 W)
F32_FLOPS = 67e12           # NVIDIA H100 SXM float32 peak outside the tensor cores
N, M, KBLK = 42, 70, 12     # the WBC QP: variables, rows, compact H block

K1, K2, K3 = "admm_zy_iterations_res", "polish_solve_compact", "setup_batched"


def flops_of(name: str, batch: int, kw: dict, n: int = N, m: int = M) -> float:
    """Operations one launch of kernel `name` over `batch` problems needs."""
    k = KBLK
    prep = lambda sweeps: sweeps * (2 * n * n + 4 * m * n) + 2 * (n * n + m * n)
    if name == K3:
        # about 17,000 multiply-adds from the setup stages' loop bounds, plus
        # the prepare tail in the fused variant
        qpp = kw.get("qp_params")
        per = 35_000 + (prep(qpp.scaling_iters) if qpp is not None else 0)
    elif name == K1:
        mv = 2 * (2 * m * n + n * n)                 # A^T t, K^-1 ., A .
        per = kw["iters"] * mv + 2 * (n * n + m * n) + 2 * (m * n + n * n) \
            + 2 * (m * n + n * n + m * n)
    elif name == K2:
        hmv = 2 * (k * k + n)                        # the compact H or H^-1 apply
        init = 2 * hmv + 2 * (2 * m * n) + 2 * m * m
        per_ref = 3 * hmv + 4 * (2 * m * n) + 2 * m * m
        per = init + kw["refine"] * per_ref + 2 * (2 * m * n) + hmv
    else:
        raise KeyError(name)
    return float(per) * batch


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def setup_bytes(obs, ref, carry, B: int, outputs: list, fused: bool) -> int:
    """Bytes the setup kernel (finite-difference mode) must move: every
    input read once (of the carried 18 x 18 T and d(T^-1)/dt only the top
    6 rows are read; the model table is shared by all scenarios), every
    output written once, the two carry flags a byte each.  `outputs`: the
    float outputs (QP, torque-map inputs, the six float carry updates and,
    fused, the prepared tensors)."""
    read = [*obs, *ref, carry.integral_error, carry.prev_contacts,
            carry.old_T[:, :6], carry.tdot_inv[:, :6], carry.old_J_st, carry.old_J_sw]
    if fused:
        read += list(carry.qp_warm)
    # switch_flag, deriv_valid and ref_is_new read, the two flags written
    return nbytes(read) + 3 * B + nbytes(outputs) + 2 * B


def bound_seconds(flops: float, bytes_moved: float) -> float:
    """The least time the chip could take: the slower of its two peaks."""
    return max(flops / F32_FLOPS, bytes_moved / HBM_BYTES_PER_S)
