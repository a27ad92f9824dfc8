"""Where the time of the port's bench solve goes on the GPU.

Runs the PyTorch port's ``lm_solve`` on the bench problem (the problem and
options of chip_smoke.py) in three variants:

- ``kernel``: the bench options as they are, on the default routes: block
  build and per-try cost through the CUDA kernels;
- ``kernel_blocks_only``: block build through the CUDA kernel, per-try cost
  in torch (``cost_impl="torch"``);
- ``plain``: the plain PyTorch path (``block_impl="torch"``,
  ``cost_impl="torch"``).

For each: the wall time of 10 solves (host clock around work that ends in
``torch.cuda.synchronize()``), then one solve under ``torch.profiler``:
host time inside the solver's ranges (``lm_solve.build_normal_blocks``,
``lm_solve.schur_solve``, ``lm_solve.cost``), device time by kernel, and
the device busy share (sum of kernel times over the solve's wall). Needs a
CUDA device; run from the repository root:

    python scripts/profile_torch_lm.py --out <dir>

Prints a summary and writes ``<out>/profile_torch_lm.json`` plus one
gzipped Chrome trace per variant (``trace_<variant>.json.gz``).
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RUNS = 10  # timed solves per variant


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the JSON and traces")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BENCH_JAX_OPTIONS, bench_problem
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.models import lm_core

    dev = cuda_device()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    cam0, poses0, obs, mask, objp = bench_problem(torch, dev)
    opts = lm_options_from_jax(BENCH_JAX_OPTIONS)
    variants = {
        "kernel": opts,
        "kernel_blocks_only": dataclasses.replace(opts, cost_impl="torch"),
        "plain": dataclasses.replace(opts, block_impl="torch", cost_impl="torch"),
    }

    def solve(o, cam):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm_core.lm_solve(cam, poses0, obs, mask, objp, o)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for o in variants.values():  # warm-up: kernel build, allocator, cuBLAS/cuSOLVER
        solve(o, cam0)
    walls = {k: [] for k in variants}
    for r in range(RUNS):  # interleaved so drift hits every variant alike
        for name, o in variants.items():
            walls[name].append(solve(o, cam0 + 1e-5 * (r + 1))[1])

    report = {"device": card, "variants": {}}
    for name, o in variants.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (_, _, info), wall = solve(o, cam0 + 1e-5)
        prof.export_chrome_trace(os.path.join(args.out, f"trace_{name}.json.gz"))
        # Host ranges (CPU events of the solver's record_function spans) and
        # device work (CUDA kernels and copies; the spans' own GPU-side
        # annotations are excluded).
        ranges, by_name = {}, {}
        for e in prof.events():
            ms = e.time_range.elapsed_us() / 1e3
            if e.name.startswith("lm_solve."):
                if e.device_type == torch.autograd.DeviceType.CPU:
                    r = ranges.setdefault(e.name, {"count": 0, "host_ms": 0.0})
                    r["count"] += 1
                    r["host_ms"] += ms
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                k = by_name.setdefault(e.name, {"name": e.name, "count": 0, "device_ms": 0.0})
                k["count"] += 1
                k["device_ms"] += ms
        kernels = sorted(by_name.values(), key=lambda k: -k["device_ms"])
        device_ms = sum(k["device_ms"] for k in kernels)
        report["variants"][name] = {
            "wall_s_runs": walls[name],
            "wall_s_median": statistics.median(walls[name]),
            "profiled_wall_s": wall,
            "n_iters": info["n_iters"],
            "nfev": info["nfev"],
            "final_cost": info["final_cost"],
            "ranges": ranges,
            "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall,
            "n_kernel_launches": sum(k["count"] for k in kernels),
            "top_kernels": kernels[:15],
        }
        v = report["variants"][name]
        print(f"{name}: median wall_s {v['wall_s_median']:.4f} (min "
              f"{min(walls[name]):.4f} max {max(walls[name]):.4f}), n_iters "
              f"{v['n_iters']} nfev {v['nfev']}; profiled wall {wall:.4f} s, device "
              f"{device_ms:.2f} ms busy ({100 * v['device_busy_share']:.1f}%), "
              f"{v['n_kernel_launches']} kernel launches")
        for key, r in sorted(ranges.items()):
            print(f"  {key}: {r['count']} calls, host {r['host_ms']:.2f} ms")
        for k in kernels[:8]:
            print(f"  {k['device_ms']:8.3f} ms  x{k['count']:<4} {k['name'][:90]}")
    with open(os.path.join(args.out, "profile_torch_lm.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
