"""PyTorch/CUDA port of the quadruped whole-body controller.

The package mirrors the layout of the JAX package it was ported from
(`models/`, `ops/`, `control/`, `planner/`, `sim/`) but shares no code
with it: it imports `torch`, numpy and the standard library only.  Plain
tensor code is eager PyTorch with the scenario batch written out as the
leading dimension; the per-scenario kernels (the fused WBC setup, Ruiz
prepare, ADMM, active-set polish, warm Newton-Schulz) are hand-written CUDA
C++ under `csrc/`, built with `nvcc` at first use (see
`ops/kernels/build.py`).

Entry points default to `device="cuda"`; pass `device="cpu"` to run the
plain PyTorch versions of the kernels (the CPU tests do).
"""

__version__ = "0.1.0"
