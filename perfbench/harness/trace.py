"""The traced window: ``torch.profiler`` over the window, read back from
its Chrome trace.

From the trace the harness takes the device's busy time (the union of the
intervals in which a kernel, copy or memset ran), every kernel launch with
its name, duration and grid, and the host's profiler ranges (the program's
``record_function`` spans and the harness's own). The trace is written to
a temporary file under ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "perfbench.window"


class Trace:
    """Events of one traced window. Times are seconds; ``kernels`` holds
    (name, start, duration, grid) and ``ranges`` (name, start, duration) of
    the host's profiler ranges, both in the trace's clock."""

    def __init__(self, events):
        self.kernels, self.ranges, device = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            start, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
            if cat in DEVICE_CATS:
                device.append((start, start + dur, e["name"]))
                if cat == "kernel":
                    self.kernels.append((e["name"], start, dur,
                                         tuple(e.get("args", {}).get("grid", ()))))
            elif cat == "user_annotation":
                self.ranges.append((e["name"], start, dur))
        window = [r for r in self.ranges if r[0] == WINDOW_RANGE]
        if window:
            self.t0, self.t1 = window[0][1], window[0][1] + window[0][2]
        else:
            self.t0 = min((s for s, _, _ in device), default=0.0)
            self.t1 = max((t for _, t, _ in device), default=0.0)
        self.device = sorted((max(s, self.t0), min(t, self.t1), n) for s, t, n in device
                             if t > self.t0 and s < self.t1)
        self.busy = _union(self.device)

    @property
    def window_s(self):
        return self.t1 - self.t0

    @property
    def busy_s(self):
        return sum(t - s for s, t in self.busy)

    def range_s(self, name):
        """Summed seconds of the host ranges called ``name``."""
        return sum(d for n, _, d in self.ranges if n == name)

    def kernel_launches(self, predicate):
        """(name, duration, grid) of the kernels whose name satisfies ``predicate``."""
        return [(n, d, g) for n, _, d, g in self.kernels if predicate(n)]

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the innermost host range open when each gap began
        ("host" where none was)."""
        ops = collections.Counter()
        for s, t, n in self.device:
            ops[_short(n)] += t - s
        gaps = collections.Counter()
        edges = [self.t0] + [x for s, t in self.busy for x in (s, t)] + [self.t1]
        ranges = sorted((s, s + d, n) for n, s, d in self.ranges if n != WINDOW_RANGE)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_innermost(ranges, a)] += b - a
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


def _union(intervals):
    out = []
    for s, t, _ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(x) for x in out]


def _innermost(ranges, t):
    best = "host"
    best_start = None
    for s, e, n in ranges:
        if s > t:
            break
        if e >= t and (best_start is None or s >= best_start):
            best, best_start = n, s
    return best


def _short(name, n=120):
    return name if len(name) <= n else name[: n - 3] + "..."


@contextlib.contextmanager
def traced(device):
    """Profile the enclosed window; yields a list that holds the Trace once
    the block has ended. CUDA activity is traced where the device is a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = []
    with profile(activities=activities) as prof:
        yield out
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.append(Trace(events))
