"""Where a RollingCalibrator update's time goes on the card.

    python scripts/profile_torch_streaming.py --out chiprun_out/<dir>

At chip_smoke phase 19's shape (BASELINE.json config 4: 64 cameras, window
256, batches of 8; scripts/bench_streaming.py:16-19), on one CUDA device:

1. the camera-batched pose init (``initialize._batched_estimate_pose``) on
   one batch: wall (median of 5, synchronised) and, from one
   ``torch.profiler`` pass, the device time and calls of the top operators
   and kernels;
2. the same batch through the per-camera loop of ``_estimate_pose_impl``
   (wall), for comparison;
3. after filling the window, 3 updates under the profiler: each
   ``rolling.*`` range's host ms, the device busy ms (kernels and copies,
   not the ranges' mirrors on the device timeline), and the top operators
   by device time.

Prints one JSON summary line (also written to ``<out>/streaming_profile.json``)
with the card's name and power limit. Needs a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CAMERAS, WINDOW, BATCH = 64, 256, 8


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def top_ops(prof, n=12):
    """[(operator, device ms, calls)] of the aten operators and kernels with
    the most device time (self, so nested operators are not counted twice)."""
    rows = []
    for a in prof.key_averages():
        if a.key.startswith(("rolling.", "lm_solve.")):  # ranges, not device work
            continue
        dev_us = getattr(a, "self_device_time_total", None)
        if dev_us is None:
            dev_us = a.self_cuda_time_total
        if dev_us > 0:
            rows.append((a.key[:80], dev_us / 1e3, a.count))
    return sorted(rows, key=lambda r: -r[1])[:n]


def main():
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.models import initialize
    from chip_smoke import is_annotation

    dev = cuda_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rig = mct.make_synthetic_rig(N_CAMERAS, WINDOW + BATCH * 8, noise_px=0.3, dropout=0.25,
                                 seed=11)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)  # noqa: E731
    uvs = as_t(rig.all_calib_uvs[:, :BATCH])
    Ks = as_t(np.stack([K for K, _ in rig.all_intrinsics]))
    ds = as_t(np.stack([d for _, d in rig.all_intrinsics]))
    objp = as_t(rig.calib_objpoints)

    def batched():
        return initialize._batched_estimate_pose(uvs, Ks, ds, objp)

    def loop():
        return [initialize._estimate_pose_impl(uvs[c], Ks[c], ds[c], objp)
                for c in range(N_CAMERAS)]

    out = {"card": card, "shape": [N_CAMERAS, BATCH, objp.shape[0]]}
    for name, fn in (("pose_init_batched", batched), ("pose_init_loop", loop)):
        fn()
        walls = [timed(fn) for _ in range(5)]
        out[name + "_s"] = {"median": statistics.median(walls), "runs": walls}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batched()
        torch.cuda.synchronize()
    out["pose_init_top_device_ops"] = top_ops(prof)

    rc = mct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                               window=WINDOW, device=dev)
    f = 0
    while rc.occupancy < WINDOW:
        rc.update(rig.all_calib_uvs[:, f:f + BATCH])
        f += BATCH
    updates = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: rc.update(rig.all_calib_uvs[:, f:f + BATCH]))
        f += BATCH
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        ranges = {}
        for e in events:
            if e.name.startswith("rolling.") and e.device_type != cuda:
                ranges[e.name] = ranges.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cuda and not is_annotation(e)) / 1e3
        updates.append({"wall_ms": 1e3 * wall, "ranges_ms": ranges, "device_busy_ms": busy,
                        "top_device_ops": top_ops(prof, 8)})
    out["updates_under_profiler"] = updates
    line = json.dumps(out)
    with open(os.path.join(args.out, "streaming_profile.json"), "w") as fh:
        fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
