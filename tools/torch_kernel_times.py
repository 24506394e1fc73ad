#!/usr/bin/env python3
"""Device times of the solver kernels of the tree this script sits in, on one
CUDA card, and a bit-for-bit comparison of two trees' outputs.

    python3 tools/torch_kernel_times.py [--label tree] [--reps 50]
        [--kernel admm_zy,admm,polish,ns_warm,setup] [--iters 0,40] [--refine 0,5]
        [--sweeps 0,4] [--case main,resolving] [--batches 4096,128,37] [--dump DIR]
    python3 tools/torch_kernel_times.py --compare DIR_A DIR_B
    python3 tools/torch_kernel_times.py --first-k4 5 --kernel none

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
    B = 4096 and 128 (round 1 and the rescue of the sigma path); `--iters`
    as for admm_zy (160: the cold start's call);
  * polish: the compact and dense polish (K2, K7) at B = 4096, 128, 64 and
    32 (round 1, the rescue, the drop round, the rescue's round 2);
    `--refine` times other numbers of refinement passes;
  * ns_warm: the warm Newton-Schulz update (K8) on all five of
    `chip_smoke.ns_warm_cases` (n = 42 and, "n70", n = 70; a NaN, a far and
    a blown-up warm start) at B = 4096, 128 and the ragged 37, whatever
    `--case` says; `--iters` times other numbers of steps (0: the loads,
    the check and the guard alone);
  * `--case` takes other cases of `chip_smoke.kernel_problem` besides (or
    instead of) "main" (e.g. "resolving": the same problems far from
    converged), `--batches` other batch sizes (e.g. the ragged 37) for
    every kernel group but setup;
  * setup: the fused setup kernel's plain and fused variants (K3) and its
    exact mode (K3x, fused) at B = 4096, 128 and the ragged 37, on
    `chip_smoke.setup_args` (recorded step 60, contact switches), and the
    prepare kernel (K4) at the same batches on the kernel problem, at the
    shipped 4 Ruiz sweeps or at each of `--sweeps` (0: its loads and
    writes alone); every output of the setup result, the carry updates and
    the prepared tensors is dumped.

`--first-k4 N` first times the prepare kernel (K4, B = 4096, float32) N
times in a row, right after the build and before anything else, as
`chip_smoke.py` times it first (median of 20, host ahead), each reading
beside the SM clock `nvidia-smi` read just before it: whether a first
reading after the card idled through the build is the kernel's time.

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
           "polish": ("polish_solve_compact", "polish_solve_dense"),
           "ns_warm": ("ns_inverse_warm",)}
BATCHES = {"admm_zy": (4096, 128), "admm": (4096, 128), "polish": (4096, 128, 64, 32),
           "ns_warm": (4096, 128, 37)}
OUTPUTS = {"admm_zy_iterations_res": "x z y pr du sv", "admm_iterations_res":
           "x z y pr du sv", "admm_iterations": "x z y",
           "polish_solve_compact": "x y z pr du sv", "polish_solve_dense": "x y z pr du sv",
           "ns_inverse_warm": "X"}


def sub_batch(args, b):
    """The first b scenarios of a kernel's arguments, contiguous (a copy of
    chip_smoke.sub_batch: the tool also runs in checkouts without it)."""
    take = lambda t: t[:b].contiguous() if isinstance(t, torch.Tensor) else t
    return tuple(tuple(take(x) for x in a) if isinstance(a, tuple) else take(a)
                 for a in args)


def setup_sub_batch(args, b):
    """The first b scenarios of the setup kernel's arguments (model, params,
    obs, ref, carry, ref_is_new), contiguous, the named tuples kept."""
    def take(x):
        if isinstance(x, torch.Tensor):
            return x[:b].contiguous()
        return type(x)(*map(take, x)) if isinstance(x, tuple) else x
    return tuple(take(a) for a in args)


SETUP_VARIANTS = {   # name: (exact_mode, fused)
    "setup_batched_plain_variant": (False, False), "setup_batched": (False, True),
    "setup_batched_exact": (True, True)}
SETUP_BATCHES = (4096, 128, 37)


def setup_runs(chip_smoke, dtype, sweeps=None):
    """(name, B, tag, wrapper call, plain call, output names) of the setup
    group; tag: {"sweeps": s} of the prepare kernel at `sweeps` (default
    the shipped count), else {}."""
    from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_k

    qpp = QPSolverParams()
    full = chip_smoke.setup_args(4096, dtype, np.random.default_rng(0))
    for name, (exact, fused) in SETUP_VARIANTS.items():
        kw = dict(exact_mode=exact, qp_params=qpp if fused else None)
        outs = chip_smoke.SETUP_OUT if fused else chip_smoke.SETUP_RESULT + chip_smoke.SETUP_CARRY
        for b in SETUP_BATCHES:
            a = setup_sub_batch(full, b)
            yield (name, b, {},
                   lambda a=a, kw=kw: chip_smoke.setup_flat(setup_k.setup_batched(*a, **kw)),
                   lambda a=a, kw=kw: chip_smoke.setup_flat(setup_k.setup_batched_plain(*a, **kw)),
                   outs)
    cases, _ = chip_smoke.kernel_problem(4096, dtype, np.random.default_rng(0))
    _, _, fn, plain, a, kw = next(c for c in cases if c[0] == "prepare_scaled")
    for s in (sweeps or [kw["sweeps"]]):
        for b in SETUP_BATCHES:
            ab, ks = sub_batch(a, b), dict(kw, sweeps=s)
            yield ("prepare_scaled", b, {"sweeps": s}, lambda ab=ab, ks=ks: fn(*ab, **ks),
                   lambda ab=ab, ks=ks: plain(*ab, **ks), chip_smoke.PREP_OUT)


def time_setup(chip_smoke, args, card):
    sweeps = [int(s) for s in args.sweeps.split(",")] if args.sweeps else None
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        with torch.no_grad():
            for name, b, tag, fn, plain, outs in setup_runs(chip_smoke, dtype, sweeps):
                got, want = fn(), plain()
                err = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want))
                ms = chip_smoke.time_ms(fn, reps=args.reps, host_ahead=True)
                if args.dump:
                    for o, t in zip(outs, got):
                        np.save(os.path.join(args.dump, f"{name}_{dt}_B{b}" + "".join(
                            f"_{k}{v}" for k, v in tag.items()) + f"_{o}.npy"),
                                t.cpu().numpy())
                print(json.dumps({"label": args.label, "kernel": name, "dtype": dt, "B": b,
                                  **tag, "ms": ms, "max_abs_err_vs_plain": err,
                                  "card": card}), flush=True)


def sm_clock():
    """The SM clock and its maximum in MHz, and the performance state, as
    nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,pstate", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return out


def first_k4(chip_smoke, args, card):
    with torch.no_grad():
        cases, _ = chip_smoke.kernel_problem(4096, torch.float32, np.random.default_rng(0))
        _, _, fn, _, a, kw = next(c for c in cases if c[0] == "prepare_scaled")
        for k in range(args.first_k4):
            clock = sm_clock()
            ms = chip_smoke.time_ms(lambda: fn(*a, **kw), host_ahead=True)
            print(json.dumps({"label": args.label, "kernel": "prepare_scaled", "reading": k,
                              "ms": ms, "sm_clock_before": clock, "card": card}), flush=True)


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
    key = {"polish": "refine", "ns_warm": "warm_iters"}.get(group, "iters")
    given = args.refine if group == "polish" else args.iters
    return key, [int(r) for r in given.split(",")] if given is not None else [kw[key]]


def dump_name(name, case, dt, b, key, v, o):
    """File name of one dumped output; the main case keeps the short form."""
    tag = name if case == "main" else f"{name}_{case}"
    return f"{tag}_{dt}_B{b}_{key}{v}_{o}.npy"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweeps", default=None,
                    help="comma-separated Ruiz sweeps of the prepare kernel (setup group) "
                         "to time instead of the shipped 4 (0: loads and writes alone)")
    ap.add_argument("--kernel", default="admm_zy,admm,polish",
                    help="comma-separated, of " + ", ".join(KERNELS) + ", setup")
    ap.add_argument("--iters", default=None,
                    help="comma-separated ADMM iteration counts of admm_zy and admm, or "
                         "Newton-Schulz steps of ns_warm, to time instead of the main "
                         "path's (0: load and epilogue, or the check, alone)")
    ap.add_argument("--refine", default=None,
                    help="comma-separated refinement passes of the polish to time "
                         "instead of the main path's (a diagnosis: the cost of one pass)")
    ap.add_argument("--case", default="main",
                    help="comma-separated cases of chip_smoke.kernel_problem to time")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes instead of each group's own")
    ap.add_argument("--dump", default=None, help="write the outputs as .npy here")
    ap.add_argument("--first-k4", type=int, default=0,
                    help="time K4 this many times first, right after the build")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("DIR_A", "DIR_B"))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    groups, cases_wanted = args.kernel.split(","), args.case.split(",")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.lib()
    print(json.dumps({"label": args.label, "nvcc_s": build.build_seconds,
                      "ptxas": [ln.strip() for ln in build.build_log.splitlines()
                                if "registers" in ln or "spill" in ln or "==" in ln
                                or "error" in ln.lower()]}), flush=True)
    if args.first_k4:
        first_k4(chip_smoke, args, card)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    if "setup" in groups:
        time_setup(chip_smoke, args, card)
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            cases, _ = chip_smoke.kernel_problem(4096, dtype, np.random.default_rng(0))
            for name, case, fn, plain, a, kw in cases:
                group = next((g for g in groups if name in KERNELS.get(g, ())), None)
                if group is None or (case not in cases_wanted and group != "ns_warm"):
                    continue
                key, values = counts(group, kw, args)
                batches = [int(b) for b in args.batches.split(",")] if args.batches \
                    else BATCHES[group]
                for b, v in ((b, v) for b in batches for v in values):
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
                            np.save(os.path.join(args.dump,
                                                 dump_name(name, case, dt, b, key, v, o)),
                                    t.cpu().numpy())
                    print(json.dumps({"label": args.label, "kernel": name, "case": case,
                                      "dtype": dt, "B": b, key: v, "ms": ms,
                                      "max_abs_err_vs_plain": err, "card": card}),
                          flush=True)


if __name__ == "__main__":
    main()
