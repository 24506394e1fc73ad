#!/usr/bin/env python3
"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration (BENCHMARK.json's `file`), its traffic mix
(`benchmark/traffic/<traffic>.json`), the module its configuration's
"entry" names (`benchmark/entries/<entry>.py`), the limits of its
comparison (`benchmark/limits/<cell>.json`) and each per-layer metric's
reader (`benchmark/metrics/<metric>.py`).  A cell or a metric is added by
adding such files and entries.

A run: set-up (imports, the program's kernels loaded or built, the inputs
made on the card from the seed, one warm pass), then the window of
`--seconds`, then, with `--trace 1`, a short traced segment, then the
comparison with the reference once the program's state is freed.  With
`--trace 0` the metrics are the cell's end-to-end ones, with `--trace 1`
its per-layer ones.  Exits non-zero and prints no result without enough
CUDA devices, or when the process holds JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import trace as trace_mod  # noqa: E402
from benchmark.spy import LaunchSpy  # noqa: E402

# whole top-level module names the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "quadrupedwholebodycontroller_tpu")
PORT = "quadrupedwholebodycontroller_tpu_torch"


class Refused(Exception):
    """A run that prints no result: the message goes to standard error."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: str, name: str):
    """(benchmark, cell, configuration entry, configuration, traffic)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return bench, cell, entry, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: end-to-end with trace off,
    per-layer with trace on."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if m["moves"] in names and cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx):
    """The value the metric's reader finds, or None."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What the per-layer readers see: the window's record, the program's
    counters, the spans of the benchmark's own callbacks, and the traced
    segment with its launch records."""

    def __init__(self, record: dict, host_syncs, segment, spy, traced_steps):
        self.step_ms = record.get("step_ms")
        self.spans = record.get("spans")
        self.control_steps = record["control_steps"]
        self.window_s = record.get("window_s")
        self.host_syncs = host_syncs
        self.segment = segment
        self.spy = spy
        self.traced_steps = traced_steps


def _host_syncs():
    try:
        return importlib.import_module(PORT + ".ops.qp").HOST_SYNCS
    except (ImportError, AttributeError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = ROOT, t_start: float = T_START, batch: int | None = None) -> dict:
    """One run of cell `name`: its result line as a dict (the compared
    numbers, each beside its limit, under "compared").  `device` "cpu" and
    a small `batch` serve the tests, which drive a run without a card."""
    bench, cell, entry, config, traffic = cell_spec(root, name)
    if batch is not None:
        config = dict(config, batch=batch)
    cuda = device != "cpu"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise Refused(f"{name} needs {cell['chips']} CUDA device(s); "
                      f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    entry_mod = importlib.import_module("benchmark.entries." + config["entry"])

    c = entry_mod.Cell(config, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    # what set-up made stays alive for the run: the window's collections
    # then scan only what the window makes
    gc.collect()
    gc.freeze()
    syncs0 = _host_syncs()
    segment = trace_mod.Segment() if trace else None
    spy = LaunchSpy() if trace else None
    record = c.window(seconds, sync, segment, spy)
    syncs1 = _host_syncs()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        segment.finish()

    metrics = {}
    if trace:
        ctx = Context(record, None if syncs0 is None else syncs1 - syncs0, segment, spy,
                      record.get("traced_steps"))
        for m in cell_metrics(bench, name, True):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s,
               "scenario_steps_per_s": record["scenario_steps"] / record["window_s"]}
        ms = record.get("step_ms")
        if ms:
            e2e["step_ms_p95"] = statistics.quantiles(ms, n=20)[18] if len(ms) > 1 else ms[0]
        for m in cell_metrics(bench, name, False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    c.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = c.check()
    compared = {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits.items()}
    correct = all(x["value"] <= x["limit"] for x in compared.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": record["scenario_steps"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = segment.busy_s
        dev["window_s"] = segment.window_s
        result["breakdown"] = segment.breakdown()
    result["checked"] = numbers
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the measured process holds {found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
