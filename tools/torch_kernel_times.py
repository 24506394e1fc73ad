#!/usr/bin/env python3
"""Device times of the polish kernels (K2 compact, K7 dense) of the tree this
script sits in, on one CUDA card.

    python3 tools/torch_kernel_times.py [--label tree] [--reps 50] [--refine 0,5]

Builds the tree's kernels, makes the polish inputs of `chip_smoke.py`
(`kernel_problem`: recorded walking step 60, the warm iterate's active set,
seed 0) at B = 4096 in float32 and float64, and for B = 4096, 128, 64 and 32
(the first B scenarios: round 1, the rescue, the drop round and the
rescue's round 2 of the main path) prints one JSON line per (kernel, dtype,
B): the median device time of one call between two CUDA events with the
host enqueued ahead (`chip_smoke.time_ms(host_ahead=True)`) and the
kernel's largest difference from its plain version on those inputs
(`--refine` times other numbers of refinement passes: the cost of one
pass).  Only the wrapper `ops.kernels.polish.polish_solve` is called, so
the same file copied into another checkout times that checkout's kernels:
run it in two trees in turns (parent, change, change, parent) in one call
to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build  # noqa: E402

BATCHES = (4096, 128, 64, 32)


def sub_batch(args, b):
    """The first b scenarios of a kernel's arguments, contiguous (a copy of
    chip_smoke.sub_batch: the tool also runs in checkouts without it)."""
    take = lambda t: t[:b].contiguous() if isinstance(t, torch.Tensor) else t
    return tuple(tuple(take(x) for x in a) if isinstance(a, tuple) else take(a)
                 for a in args)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--refine", default=None,
                    help="comma-separated refinement passes to time instead of "
                         "the main path's (a diagnosis: the cost of one pass)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.lib()
    print(json.dumps({"label": args.label, "nvcc_s": build.build_seconds,
                      "ptxas": [ln.strip() for ln in build.build_log.splitlines()
                                if "polish" in ln or "registers" in ln or "spill" in ln
                                or "error" in ln.lower()]}), flush=True)
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            cases, _ = chip_smoke.kernel_problem(4096, dtype, np.random.default_rng(0))
            for name, case, fn, plain, a, kw in cases:
                if case != "main" or name not in (chip_smoke.K2, chip_smoke.K7):
                    continue
                passes = [kw["refine"]] if args.refine is None else [
                    int(r) for r in args.refine.split(",")]
                for b, refine in ((b, r) for b in BATCHES for r in passes):
                    ab, kr = sub_batch(a, b), dict(kw, refine=refine)
                    got = fn(*ab, **kr)
                    want = plain(*ab, **kr)
                    err = max(float((g.double() - w.double()).abs().max())
                              for g, w in zip(got, want))
                    ms = chip_smoke.time_ms(lambda: fn(*ab, **kr), reps=args.reps,
                                            host_ahead=True)
                    print(json.dumps({"label": args.label, "kernel": name,
                                      "dtype": str(dtype)[6:], "B": b, "refine": refine,
                                      "ms": ms, "max_abs_err_vs_plain": err,
                                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
