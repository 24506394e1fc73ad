#!/usr/bin/env python3
"""Where the fused setup kernel's time goes, section by section, on one CUDA
card: the twin of `tools/profile_setup_sections.py` (the JAX package's).

    python3 tools/torch_setup_sections.py [--label tree] [--reps 20]
        [--batch 4096] [--exact] [--dump DIR]

Builds the tree's kernels and times `ops.kernels.setup.setup_batched` in
float32 on the inputs of `chip_smoke.py` (`setup_args`: recorded walking
step 60, a warmed carry, contact switches in part of the batch, seed 0),
cut after each section of `setup.SECTIONS` by its `stop_after` probe, then
whole without the prepare tail (`full_plain`) and with it (`prepare`).  One
JSON line a section: the cumulative device ms (median of CUDA-event
timings, host enqueued ahead) and the marginal ms, the difference from the
section before; then one summary line with what ptxas made of the probes
and of the whole kernels (registers, stack, spills).  `--exact` times the
exact mode (K3x) instead.  `--dump DIR` writes each probe's checksums
(`com`) as `.npy` files, for `tools/torch_kernel_times.py --compare`
against another tree's: the first section whose sums differ is where two
kernels part.

`--host` times the wrapper's host side instead (K3 fused, the same inputs;
run it with `--batch 128`, where the card keeps up with the host): the host
microseconds of one `setup_batched` call, back to back (the median of seven
batches), and under cProfile the time of each function the call spends it
in (the input checks, the output allocations, the pointer table, the
launch).
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def host_parts(setup, label, card, calls=2000):
    """Host microseconds of one fused K3 call and its parts (cProfile)."""
    from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_k

    qpp = QPSolverParams()
    call = lambda: setup_k.setup_batched(*setup, qp_params=qpp)
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    batches = []   # the host is shared: the median of seven batches
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(calls // 7):
            call()
        batches.append((time.perf_counter() - t0) / (calls // 7) * 1e6)   # enqueue only
        torch.cuda.synchronize()
    host_us = statistics.median(batches)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        call()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())   # tottime over every function
    parts = sorted(((v[2] / calls * 1e6, f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
                    for k, v in st.stats.items()), reverse=True)[:15]
    print(json.dumps({"label": label, "host_us_per_call": host_us,
                      "host_us_batches": batches,
                      "profiled_us_per_call": total / calls * 1e6,
                      "tottime_us_per_call": [[round(us, 2), name] for us, name in parts],
                      "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--host", action="store_true", help="the wrapper's host time by parts")
    ap.add_argument("--dump", default=None, help="write each probe's checksums here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.lib()
    with torch.no_grad():
        setup = chip_smoke.setup_args(args.batch, torch.float32, np.random.default_rng(0))
        if args.host:
            return host_parts(setup, args.label, card)
        times = chip_smoke.setup_section_times(setup, reps=args.reps, exact=args.exact)
    kernel = "setup_batched_exact" if args.exact else "setup_batched"
    if args.dump:
        from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_k

        os.makedirs(args.dump, exist_ok=True)
        for sec in setup_k.SECTIONS:
            com = setup_k.setup_batched(*setup, exact_mode=args.exact, stop_after=sec)["com"]
            np.save(os.path.join(args.dump, f"{kernel}_{sec}.npy"), com.cpu().numpy())
    for sec, (cum, marginal) in times.items():
        print(json.dumps({"label": args.label, "kernel": kernel, "B": args.batch,
                          "section": sec, "cum_ms": cum, "marginal_ms": marginal,
                          "card": card}), flush=True)
    print(json.dumps({"label": args.label, "kernel": kernel, "B": args.batch,
                      "marginal_ms": {k: v[1] for k, v in times.items()},
                      "nvcc_s": build.build_seconds, "object_s": build.object_seconds,
                      "ptxas": build.ptxas_report("setup"),
                      "ptxas_sections": build.ptxas_report("setup_sections"),
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
