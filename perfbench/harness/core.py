"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, the correctness check, and the result line.

``main`` is the command line (``perfbench/run.py``): it refuses to run
without the cards the cell asks for and prints the JSON result as the last
line of standard output. ``run_cell`` is everything after that look, with
the device given, so the tests can drive a whole run on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import spec
from .trace import WINDOW_RANGE, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "multicam_calibration_tpu")
PROGRAM = "multicam_calibration_tpu_torch"


def forbidden_modules():
    """Top-level names in ``sys.modules`` that a run may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sub_seed(seed, *keys):
    """A 63-bit seed for one part of the traffic, made from the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name, seed, seconds, trace, device, overrides=None, root=spec.ROOT,
             t_start=None):
    """Run cell ``name`` once on ``device``; returns the result dict (whose
    last key is ``checks``). ``overrides`` ({"config": {...}, "mix": {...}})
    shrink a cell for the CPU tests."""
    import torch
    from torch.profiler import record_function

    from multicam_calibration_tpu_torch.utils.metrics import metrics as program_metrics

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(name, root)
    for key, extra in (overrides or {}).items():
        getattr(cell, key).update(extra)
    t_inputs = time.perf_counter()
    job = spec.job_module(cell.mix["job"]).Job(cell.config, cell.mix, seed, device,
                                               seconds=seconds)
    t_warm = time.perf_counter()
    job.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"perfbench: set-up {setup_s:.3f} s: start {t_inputs - t_start:.3f}, inputs "
          f"{t_warm - t_inputs:.3f}, warm-up {t_start + setup_s - t_warm:.3f}", file=sys.stderr)

    # A window ends with a whole cycle of the job's inputs (``job.cycle``
    # jobs), so every window holds the same work. A traced window may stop
    # after the mix's ``trace_jobs`` jobs: the trace of a launch-bound job
    # is large, and reading it counts against the run's time.
    most = cell.mix.get("trace_jobs") if trace else None
    stages0 = dict(program_metrics.stage_times)
    record = []
    holder = []
    with (traced(device) if trace else contextlib.nullcontext(holder)) as holder:
        with record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            while True:
                a = time.perf_counter()
                units = job.step()
                b = time.perf_counter()
                record.append((a, b, units))
                if (b - t0 >= seconds and len(record) % job.cycle == 0) or len(record) == most:
                    break
    window_s = record[-1][1] - t0
    job.close()
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"perfbench: {', '.join(bad)} loaded during the run; no result")

    result = {"correct": None, "attempted": int(sum(u for _, _, u in record)), "failed": 0}
    devinfo = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
               "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        tr = holder[0]
        stages = {k: v - stages0.get(k, 0.0) for k, v in program_metrics.stage_times.items()}
        ctx = {"trace": tr, "window_s": window_s, "stage_times": stages, "spans": job.spans,
               "shapes": job.shapes(), "jobs": len(record), "units": result["attempted"]}
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        devinfo.update(busy_s=tr.busy_s / cell.chips, window_s=tr.window_s)
    else:
        produced = job.end_to_end(record, window_s)
        produced["setup_s"] = setup_s
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in produced:
                raise RuntimeError(f"cell {name} does not produce {m['name']}")
            metrics[m["name"]] = {"value": float(produced[m["name"]]), "unit": m["unit"]}

    # The check runs once the window has closed and the peak is read: a
    # reference on the card must not set the peak.
    t_check = time.perf_counter()
    checks = job.check({**cell.config.get("guarantees", {}), **cell.limits})
    print(f"perfbench: window {window_s:.3f} s, {len(record)} jobs of "
          + ", ".join(f"{b - a:.3f}" for a, b, _ in record)
          + f" s; check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result.update(metrics=metrics, device=devinfo)
    if trace:
        result["breakdown"] = holder[0].breakdown()
    result["correct"] = all(v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    # ``checks`` is the line's last key.
    result = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                     *(("breakdown",) if trace else ()), "checks")}
    return result


def main(argv, t_start):
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    import multicam_calibration_tpu_torch as program

    if spec.ROOT not in Path(program.__file__).resolve().parents:
        print(f"perfbench: {PROGRAM} was imported from {program.__file__}, not from this "
              "checkout; no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0), t_start=t_start)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
