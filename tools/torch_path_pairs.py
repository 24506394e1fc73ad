#!/usr/bin/env python3
"""The scenario-steps where two paths of the control step that both certify
differ most in torque, on one CUDA card.

    python3 tools/torch_path_pairs.py [--paths exact,exact_oracle] [--top 8]

Replays the recorded walk through two of `chip_smoke.py`'s paths (`PATHS`:
kernel, torch, sigma, exact_shipped, exact, exact_oracle; B = 4096, float32,
the smoke's offsets, steps 0..69) and prints `compare_paths`'s summary,
then one JSON line per scenario-step among the `--top` largest torque gaps
where both certify (relative KKT and sign violation < 1e-5, the smoke's
measure): the step, the scenario, the gap in N.m, each side's KKT residual
and sign violation.  A gap that comes from one side's borderline
certificate shows there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="exact,exact_oracle")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    a, b = args.paths.split(",")
    offsets = cs.replay.make_offsets(cs.BATCH, torch.float32,
                                     np.random.default_rng(cs.SEED + 1), cs.DEV)
    kept = {p: cs.drive_path(p, offsets)[2] for p in (a, b)}
    try:
        summary = cs.compare_paths(kept[a], kept[b])
        summary.pop("per_step")
    except AssertionError as e:
        summary = {"assertion": str(e)}
    print(json.dumps({"paths": [a, b], **summary}), flush=True)
    rows = []
    for t, ((ta, ka, sa), (tb, kb, sb)) in enumerate(zip(kept[a], kept[b])):
        dtau = (ta.double() - tb.double()).abs().amax(dim=1)
        cert = (ka < 1e-5) & (kb < 1e-5) & (sa < 1e-5) & (sb < 1e-5)
        gap = torch.where(cert, dtau, torch.zeros_like(dtau))
        v, i = torch.topk(gap, min(args.top, gap.numel()))
        rows += [(float(x), t, int(s)) for x, s in zip(v.tolist(), i.tolist()) if x > 0]
    for gap, t, s in sorted(rows, reverse=True)[:args.top]:
        ta, ka, sa = kept[a][t]
        tb, kb, sb = kept[b][t]
        print(json.dumps({"step": t, "scenario": s, "dtau_Nm": gap,
                          "kkt": [float(ka[s]), float(kb[s])],
                          "sign_violation": [float(sa[s]), float(sb[s])]}), flush=True)


if __name__ == "__main__":
    main()
