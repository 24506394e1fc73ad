"""Hand-written Hopper kernels of the control step and their PyTorch wrappers.

Each module holds one wrapper, the plain PyTorch version of the same
function (`*_plain`, taken only for tensors that lie on the CPU) and two
module-level integer counters: `LAUNCHES` (kernel launches) and
`PLAIN_CALLS` (plain-version calls).
"""
from __future__ import annotations

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (
    admm_zy,
    polish,
    prepare,
    setup,
)

KERNEL_MODULES = {
    "prepare_scaled": prepare,
    "admm_zy_iterations_res": admm_zy,
    "polish_solve_compact": polish,
    "setup_batched": setup,
}


def reset_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
        mod.PLAIN_CALLS = 0


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def plain_counts() -> dict:
    return {name: mod.PLAIN_CALLS for name, mod in KERNEL_MODULES.items()}
