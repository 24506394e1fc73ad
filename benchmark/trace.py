"""The device trace of a short segment of a `--trace 1` run, and what the
per-layer metrics read from it.

`torch.profiler` traces the host and the card over the segment; the trace
is written as Chrome JSON under $TMPDIR, read back and deleted.  From it:
busy seconds (the union of the device's kernel, copy and set intervals),
operations, seconds by kernel name, and the idle gaps between device
operations, each put down to the host operation that ran at its middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 96


class Segment:
    """`with seg.run(): ...` (or `start()` ... `stop()`, then `finish()` once
    the window has closed) traces the work inside; afterwards `busy_s`,
    `window_s`, `device_ops`, `kernel_seconds(names)` and `breakdown()`."""

    def __init__(self):
        self.window_s = None
        self.busy_s = None
        self.device_ops = 0
        self._kernel_s = {}
        self._gaps = collections.Counter()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if self._cuda else []))
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def finish(self):
        """Read the trace of the stopped segment (after the window)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self._read(events)

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def run(self):
        self.start()
        yield self
        self.stop()
        self.finish()

    def _read(self, events):
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            if e.get("cat") in DEVICE_CATS:
                dev.append((float(e["ts"]), float(e["dur"]), e["name"]))
            elif e.get("cat") in HOST_CATS:
                host.append((float(e["ts"]), float(e["dur"]), e["name"]))
        dev.sort()
        self.device_ops = len(dev)
        for _, dur, name in dev:
            self._kernel_s[name] = self._kernel_s.get(name, 0.0) + dur * 1e-6
        # union of the device intervals, and the gaps between them
        busy, end, gaps = 0.0, None, []
        for ts, dur, _ in dev:
            if end is None or ts > end:
                if end is not None:
                    gaps.append((end, ts))
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        self.busy_s = busy * 1e-6
        host.sort()
        starts = [h[0] for h in host]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            label = "host: no traced operation"
            # the innermost host operation covering the middle of the gap
            for ts, dur, name in reversed(host[max(0, i - 256):i]):
                if ts + dur >= mid:
                    label = name
                    break
            self._gaps[label[:NAME_CHARS]] += (b - a) * 1e-6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains one of `names`."""
        return sum(s for k, s in self._kernel_s.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for k, s in self._kernel_s.items():
            ops[k[:NAME_CHARS]] += s
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in self._gaps.most_common(10)]}
