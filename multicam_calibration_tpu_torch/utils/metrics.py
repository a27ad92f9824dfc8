"""Structured metrics, stage timers, and profiling hooks.

The port's own copy of ``multicam_calibration_tpu/utils/metrics.py`` (that
module is plain Python, but importing it would import JAX through its
package):

- ``metrics.log(event, **fields)`` appends one JSON line to the configured
  sink (``metrics.configure(path)`` or env ``MCC_METRICS=/path/metrics.jsonl``).
- ``metrics.timer("stage")`` context manager records wall-clock per stage
  and logs a ``stage_time`` event.
- ``metrics.profile(logdir)`` wraps ``torch.profiler`` (CPU, plus CUDA when
  a device is present) and writes a TensorBoard trace into ``logdir``.

Pipeline stages (``calibrate``, ``bundle_adjust``) call into the global
``metrics`` object; nothing is written unless a sink is configured. A stage
timer reads the host clock and does not synchronise the device: a stage
that ends in a host read (every stage of the two pipelines does) is timed
to the end of its device work.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

__all__ = ["Metrics", "metrics"]


class Metrics:
    def __init__(self):
        self._path: Optional[str] = os.environ.get("MCC_METRICS") or None
        self._file = None
        self.stage_times: dict[str, float] = {}

    # -- configuration -----------------------------------------------------
    def configure(self, path: Optional[str]):
        """Set (or clear, with None) the JSONL sink path."""
        if self._file is not None:
            self._file.close()
            self._file = None
        self._path = path
        return self

    @property
    def enabled(self) -> bool:
        return self._path is not None

    # -- events --------------------------------------------------------------
    def log(self, event: str, **fields):
        """Append one structured event; no-op when no sink is configured."""
        if self._path is None:
            return
        if self._file is None:
            self._file = open(self._path, "a", buffering=1)
        rec = {"t": round(time.time(), 6), "event": event}
        rec.update(fields)
        self._file.write(json.dumps(rec, default=_jsonable) + "\n")

    @contextlib.contextmanager
    def timer(self, stage: str, **fields):
        """Record wall-clock of a pipeline stage (always kept in
        ``stage_times``; logged as a ``stage_time`` event when enabled)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stage_times[stage] = self.stage_times.get(stage, 0.0) + dt
            self.log("stage_time", stage=stage, seconds=round(dt, 6), **fields)

    @contextlib.contextmanager
    def profile(self, logdir: str):
        """Capture a torch.profiler trace of the enclosed region."""
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            yield

    def summary(self) -> dict:
        return dict(self.stage_times)


def _jsonable(x):
    try:
        return float(x)
    except Exception:
        return str(x)


#: process-global metrics object used by the pipeline stages.
metrics = Metrics()
