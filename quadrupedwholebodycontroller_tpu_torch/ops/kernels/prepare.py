"""Ruiz equilibration + problem/warm-start scaling (kernel K4).

`prepare_scaled` replaces the JAX package's Pallas kernel
`ops/pallas/prepare_kernel.py::prepare_scaled` (`_prepare_kernel`): per
scenario, `sweeps` Ruiz sweeps on |H|, |A| give the scalings (d, e); one
pass then writes the scaled problem, the per-row ADMM penalty rho and the
scaled warm start.  Equality rows are detected on the UNSCALED bounds.

On a CUDA tensor the wrapper launches `csrc/prepare.cu`; on a CPU tensor
it takes `prepare_scaled_plain`.
"""
from __future__ import annotations

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

LAUNCHES = {"prepare_scaled": 0}
PLAIN_CALLS = {"prepare_scaled": 0}


def prepare_scaled_plain(H, A, g, l, u, wx, wz, wy, *, sweeps: int,
                         rho0: float, rho_eq_scale: float):
    """Plain PyTorch version, in the kernel's operation order."""
    PLAIN_CALLS["prepare_scaled"] += 1
    absH = torch.abs(H)
    absA = torch.abs(A)
    d = torch.ones_like(g)
    e = torch.ones_like(l)
    for _ in range(sweeps):
        Hs = absH * d[:, None, :] * d[:, :, None]
        As = absA * e[:, :, None] * d[:, None, :]
        cx = torch.maximum(torch.amax(Hs, dim=1), torch.amax(As, dim=1))  # (B, n)
        rz = torch.amax(As, dim=2)                                        # (B, m)
        d = d * torch.rsqrt(torch.clamp_min(cx, 1e-8))
        e = e * torch.rsqrt(torch.clamp_min(rz, 1e-8))
    sH = H * d[:, None, :] * d[:, :, None]
    sA = A * e[:, :, None] * d[:, None, :]
    eq = (u - l) <= 1e-9
    rho = torch.where(
        eq,
        torch.full_like(l, rho0 * rho_eq_scale),
        torch.full_like(l, rho0),
    )
    return (sH, sA, d * g, e * l, e * u, rho, wx / d, wz * e, wy / e, d, e)


def prepare_scaled(H, A, g, l, u, wx, wz, wy, *, sweeps: int, rho0: float,
                   rho_eq_scale: float):
    """Batch-major (B, ...) in and out.  Returns
    (sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e).  Refuses an input that
    requires grad (`build.refuse_grad`)."""
    build.refuse_grad("prepare_scaled", H, A, g, l, u, wx, wz, wy)
    if H.device.type == "cpu":
        return prepare_scaled_plain(
            H, A, g, l, u, wx, wz, wy,
            sweeps=sweeps, rho0=rho0, rho_eq_scale=rho_eq_scale,
        )
    B, m, n = A.shape
    suffix = build.check_inputs(H, {
        "H": (H, (B, n, n)), "A": (A, (B, m, n)), "g": (g, (B, n)),
        "l": (l, (B, m)), "u": (u, (B, m)),
        "wx": (wx, (B, n)), "wz": (wz, (B, m)), "wy": (wy, (B, m)),
    })
    if max(n, m) > 1024:
        raise ValueError(f"prepare kernel takes n, m <= 1024, got {n}, {m}")
    new = lambda *shape: torch.empty(shape, dtype=H.dtype, device=H.device)
    outs = (new(B, n, n), new(B, m, n), new(B, n), new(B, m), new(B, m),
            new(B, m), new(B, n), new(B, m), new(B, m), new(B, n), new(B, m))
    if B == 0:
        return outs
    build.launch(
        "prepare", suffix,
        *(t.data_ptr() for t in (H, A, g, l, u, wx, wz, wy)),
        *(t.data_ptr() for t in outs),
        B, n, m, int(sweeps), float(rho0), float(rho0 * rho_eq_scale),
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    LAUNCHES["prepare_scaled"] += 1
    return outs
