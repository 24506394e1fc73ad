#!/usr/bin/env python3
"""Device times of the solver kernels of the tree this script sits in, on one
CUDA card, and a bit-for-bit comparison of two trees' outputs.

    python3 tools/torch_kernel_times.py [--label tree] [--reps 50]
        [--kernel admm_zy,admm,polish] [--iters 0,40] [--refine 0,5]
        [--dump DIR]
    python3 tools/torch_kernel_times.py --compare DIR_A DIR_B

Builds the tree's kernels, makes the inputs of `chip_smoke.py`
(`kernel_problem`: recorded walking step 60, the warm iterate and its active
set, seed 0) at B = 4096 in float32 and float64, and prints one JSON line per
(kernel, dtype, B, iterations or refinement passes): the median device time
of one call between two CUDA events with the host enqueued ahead
(`chip_smoke.time_ms(host_ahead=True)`) and the kernel's largest difference
from its plain version on those inputs.  The kernels and batches:

  * admm_zy: the constraint-space ADMM (K1) at B = 4096 and 128 (round 1
    and the rescue of the main path); `--iters` times other iteration counts
    (0: the load and the epilogue alone; the main path's 40 by default);
  * admm: the x-space ADMM with and without its epilogue (K5, K6) at
    B = 4096;
  * polish: the compact and dense polish (K2, K7) at B = 4096, 128, 64 and
    32 (round 1, the rescue, the drop round, the rescue's round 2);
    `--refine` times other numbers of refinement passes.

`--dump DIR` writes every timed call's outputs as `.npy` files (one a
kernel, dtype, B, count and output); `--compare DIR_A DIR_B` (no card
needed) prints the largest difference of each output present in both, 0
where bit-identical, and a last line saying whether all are.  Only the
wrappers are called, so the same file copied into another checkout times
that checkout's kernels: run it in two trees in turns (parent, change,
change, parent) in one call, each with its own `--dump`, then compare.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

KERNELS = {"admm_zy": ("admm_zy_iterations_res",),
           "admm": ("admm_iterations_res", "admm_iterations"),
           "polish": ("polish_solve_compact", "polish_solve_dense")}
BATCHES = {"admm_zy": (4096, 128), "admm": (4096,), "polish": (4096, 128, 64, 32)}
OUTPUTS = {"admm_zy_iterations_res": "x z y pr du sv", "admm_iterations_res":
           "x z y pr du sv", "admm_iterations": "x z y",
           "polish_solve_compact": "x y z pr du sv", "polish_solve_dense": "x y z pr du sv"}


def sub_batch(args, b):
    """The first b scenarios of a kernel's arguments, contiguous (a copy of
    chip_smoke.sub_batch: the tool also runs in checkouts without it)."""
    take = lambda t: t[:b].contiguous() if isinstance(t, torch.Tensor) else t
    return tuple(tuple(take(x) for x in a) if isinstance(a, tuple) else take(a)
                 for a in args)


def compare(dir_a, dir_b):
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    if not names:
        sys.exit(f"no output present in both {dir_a} and {dir_b}")
    identical = True
    for f in names:
        a, b = np.load(os.path.join(dir_a, f)), np.load(os.path.join(dir_b, f))
        same = a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
        diff = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) \
            if a.shape == b.shape else None
        identical &= same
        print(json.dumps({"output": f[:-4], "max_abs_diff": diff, "bit_identical": same}))
    print(json.dumps({"compared": len(names), "only_in_one": len(
        set(os.listdir(dir_a)) ^ set(os.listdir(dir_b))), "all_bit_identical": identical}))


def counts(group, kw, args):
    """(keyword, the counts to time) of a kernel."""
    if group == "admm_zy" and args.iters is not None:
        return "iters", [int(r) for r in args.iters.split(",")]
    if group == "polish" and args.refine is not None:
        return "refine", [int(r) for r in args.refine.split(",")]
    key = "refine" if group == "polish" else "iters"
    return key, [kw[key]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernel", default="admm_zy,admm,polish",
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--iters", default=None,
                    help="comma-separated ADMM iteration counts of admm_zy to time "
                         "instead of the main path's (0: load and epilogue alone)")
    ap.add_argument("--refine", default=None,
                    help="comma-separated refinement passes of the polish to time "
                         "instead of the main path's (a diagnosis: the cost of one pass)")
    ap.add_argument("--dump", default=None, help="write the outputs as .npy here")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("DIR_A", "DIR_B"))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    groups = args.kernel.split(",")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.lib()
    print(json.dumps({"label": args.label, "nvcc_s": build.build_seconds,
                      "ptxas": [ln.strip() for ln in build.build_log.splitlines()
                                if "registers" in ln or "spill" in ln or "==" in ln
                                or "error" in ln.lower()]}), flush=True)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            cases, _ = chip_smoke.kernel_problem(4096, dtype, np.random.default_rng(0))
            for name, case, fn, plain, a, kw in cases:
                group = next((g for g in groups if name in KERNELS.get(g, ())), None)
                if case != "main" or group is None:
                    continue
                key, values = counts(group, kw, args)
                for b, v in ((b, v) for b in BATCHES[group] for v in values):
                    ab, kr = sub_batch(a, b), dict(kw, **{key: v})
                    got = fn(*ab, **kr)
                    want = plain(*ab, **kr)
                    err = max(float((g.double() - w.double()).abs().max())
                              for g, w in zip(got, want))
                    ms = chip_smoke.time_ms(lambda: fn(*ab, **kr), reps=args.reps,
                                            host_ahead=True)
                    dt = str(dtype)[6:]
                    if args.dump:
                        for o, t in zip(OUTPUTS[name].split(), got):
                            np.save(os.path.join(args.dump, f"{name}_{dt}_B{b}_{key}{v}_{o}.npy"),
                                    t.cpu().numpy())
                    print(json.dumps({"label": args.label, "kernel": name, "dtype": dt,
                                      "B": b, key: v, "ms": ms,
                                      "max_abs_err_vs_plain": err, "card": card}),
                          flush=True)


if __name__ == "__main__":
    main()
