"""Structured metrics: spans, counters and a JSONL event sink.

The port's own copy of ``multicam_calibration_tpu/utils/metrics.py`` (that
module is plain Python, but importing it would import JAX through its
package), with one span API in place of its timer and profiler hooks:

- ``metrics.log(event, **fields)`` appends one JSON line to the configured
  sink (``metrics.configure(path)`` or env ``MCC_METRICS=/path/metrics.jsonl``).
- ``metrics.span("name")`` context manager adds the enclosed block's
  host seconds to ``stage_times["name"]``, logs a ``stage_time`` event and,
  while a ``torch.profiler`` session is recording, opens a profiler range
  of the same name, so the span lies in the trace beside the kernels it
  launched. ``metrics.timer`` is the same method under the JAX package's
  name.
- ``metrics.count("name", n)`` adds ``n`` to ``stage_times["name"]``
  (nothing is logged).

``stage_times`` therefore holds span seconds and counter totals, keyed by
name; ``summary()`` copies it. The pipelines (detection, ``calibrate``,
``bundle_adjust``, ``lm_solve``, ``RollingCalibrator.update``) call into
the global ``metrics`` object; nothing is written unless a sink is
configured. A span reads the host clock and does not synchronise the
device: a span whose block ends in a host read is timed to the end of its
device work; one that does not (the pose spans inside ``torch.vmap``)
times the host's launches. Outside a profiler session a span opens no
range: a ``record_function`` costs more than the rest of the span (two
clock reads, a dict update) even with no profiler to record it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
from torch.profiler import record_function

__all__ = ["Metrics", "metrics"]


class Metrics:
    def __init__(self):
        self._path: Optional[str] = os.environ.get("MCC_METRICS") or None
        self._file = None
        self.stage_times: dict[str, float] = {}  # span seconds, counter totals

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
    def span(self, name: str, **fields):
        """Time the enclosed block as span ``name``: its seconds are added
        to ``stage_times[name]`` and logged as a ``stage_time`` event (with
        ``fields``) when a sink is configured; under an active
        ``torch.profiler`` session the block is also a profiler range
        called ``name``."""
        ranged = torch.autograd._profiler_enabled()
        t0 = time.perf_counter()
        try:
            with record_function(name) if ranged else contextlib.nullcontext():
                yield
        finally:
            dt = time.perf_counter() - t0
            self.stage_times[name] = self.stage_times.get(name, 0.0) + dt
            self.log("stage_time", stage=name, seconds=round(dt, 6), **fields)

    #: The JAX package's name for :meth:`span`.
    timer = span

    def count(self, name: str, n=1):
        """Add ``n`` to counter ``name`` in ``stage_times``."""
        self.stage_times[name] = self.stage_times.get(name, 0) + n

    def summary(self) -> dict:
        return dict(self.stage_times)


def _jsonable(x):
    try:
        return float(x)
    except Exception:
        return str(x)


#: process-global metrics object used by the pipeline stages.
metrics = Metrics()
