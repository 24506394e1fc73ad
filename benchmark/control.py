#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place, computed in the precision step below the configuration's float32
(TF32 products, `--precision tf32`) or at float32 itself (`float32`),
and judged by the same comparison.  Prints one JSON line per seed with
the compared numbers beside the cell's limits; a sound comparison reads
the TF32 control as not correct.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload step.walk --seeds 11,12,13 --precision tf32
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmark import run  # noqa: E402


def control_numbers(name: str, seed: int, precision: str, device: str = "cuda",
                    batch: int | None = None) -> dict:
    _, cell, _, config, traffic = run.cell_spec(run.ROOT, name)
    if batch is not None:
        config = dict(config, batch=batch)
    entry_mod = importlib.import_module("benchmark.entries." + config["entry"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        c = entry_mod.Control(config, traffic, seed, device)
        c.run_checked_pass()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    c.release()
    return c.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--precision", choices=("tf32", "float32"), default="tf32")
    args = ap.parse_args(argv)
    limits = run.load_json(os.path.join(HERE, "limits", args.workload + ".json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(args.workload, seed, args.precision)
        compared = {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "correct": all(x["value"] <= x["limit"] for x in compared.values()),
                          "compared": compared, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
