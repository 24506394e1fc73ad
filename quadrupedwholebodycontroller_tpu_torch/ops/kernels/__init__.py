"""Hand-written Hopper kernels of the control step and their PyTorch wrappers.

Each module holds the wrappers of one CUDA source, the plain PyTorch
version of each (`*_plain`, taken only for tensors that lie on the CPU) and
two module-level dicts of counters keyed by kernel name: `LAUNCHES` (kernel
launches) and `PLAIN_CALLS` (plain-version calls).
"""
from __future__ import annotations

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (
    admm,
    admm_zy,
    ns_warm,
    polish,
    prepare,
    setup,
)

MODULES = (prepare, admm_zy, admm, polish, setup, ns_warm)
# kernel name -> its module
KERNEL_MODULES = {name: mod for mod in MODULES for name in mod.LAUNCHES}


def reset_counts() -> None:
    for mod in MODULES:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0
            mod.PLAIN_CALLS[name] = 0
    for mod in (admm_zy, admm):
        for name in mod.VARIANT_LAUNCHES:
            mod.VARIANT_LAUNCHES[name] = 0


def launch_counts() -> dict:
    return {name: mod.LAUNCHES[name] for name, mod in KERNEL_MODULES.items()}


def plain_counts() -> dict:
    return {name: mod.PLAIN_CALLS[name] for name, mod in KERNEL_MODULES.items()}
