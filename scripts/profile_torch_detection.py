"""Where the time of the port's batch-128 detection call goes on the GPU.

Builds chip_smoke.py's phase-9 input (the clean frames of
``multicam_calibration_tpu_torch/data/detect_frames.npz`` tiled to batch 128,
480x640, with seeded +-2 noise as scripts/bench_detection.py) and measures:

- end to end: the wall of 10 ``detect_chessboard_batch`` calls after a
  warm-up (host clock; the call returns numpy, so it ends synchronised), and
  one call under ``torch.profiler``: device busy share (kernel time over the
  call's wall) and kernel launches;
- per layer, the same work run stage by stage with a synchronise after
  each: upload (host stack + host-to-device copy), gray, the corner kernel
  alone, the candidates (``find_corner_candidates``: the kernel again plus
  the top-K), device lattice ordering, subpixel refinement, anchor scores,
  and the host finish
  (``_batch_finish``: device-to-host copies, strict lattice checks, anchor
  decisions). Host wall: median of 10; device time and launches: one
  profiled run of each stage.

With ``--coarse-downscale f`` (f > 1) the calls take the low-band path, and
the stages are its own: the host stack of the full-resolution frames, the
host decimation, the upload of the small frames, stage 1 at 1/f resolution
(NMS radius, template and window scaled as the path scales them), the host
finish at low resolution, and the promotion (patch gather on the host,
patch upload, full-resolution refinement, the full-resolution lattice gate).

Needs a CUDA device; run from the repository root:

    python scripts/profile_torch_detection.py --out <dir> [--coarse-downscale f]

Prints a summary and writes ``<out>/profile_torch_detection[_f<f>].json`` and
a gzipped Chrome trace of the profiled end-to-end call.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RUNS = 10
BATCH = 128


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the JSON and trace")
    ap.add_argument("--coarse-downscale", type=int, default=1,
                    help="f > 1: the low-band path (default 1: full resolution)")
    args = ap.parse_args()
    f = args.coarse_downscale
    tag = f"_f{f}" if f > 1 else ""

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.detection import detector as det
    from multicam_calibration_tpu_torch.device import cuda_device, with_highest_precision
    from multicam_calibration_tpu_torch.ops import corner_cuda

    dev = cuda_device()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    d = np.load(os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "detect_frames.npz"))
    board = tuple(int(v) for v in d["board_shape"])
    rows, cols = board
    clean = d["frames"][d["kind"] == "clean"]
    tiled = np.concatenate([clean] * -(-BATCH // len(clean)))[:BATCH]
    rng = np.random.default_rng(7)
    batches = [
        list(np.clip(tiled.astype(np.int16) + rng.integers(-2, 3, tiled.shape, dtype=np.int16),
                     0, 255).astype(np.uint8))
        for _ in range(RUNS + 1)
    ]

    def detect(images):
        return mct.detect_chessboard_batch(images, board_shape=board, coarse_downscale=f,
                                           device=dev)

    def device_work(prof):
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(e.name, {"name": e.name, "count": 0, "device_ms": 0.0})
                k["count"] += 1
                k["device_ms"] += e.time_range.elapsed_us() / 1e3
        ks = sorted(kernels.values(), key=lambda k: -k["device_ms"])
        return sum(k["device_ms"] for k in ks), sum(k["count"] for k in ks), ks

    detect(batches[0])  # warm-up: kernel build, allocator, cuSOLVER handles
    walls = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        found = detect(b)
        walls.append(time.perf_counter() - t0)
        assert len(found) == BATCH, f"detected {len(found)}/{BATCH}"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detect(batches[1])
        e2e_wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, f"trace_detect_batch128{tag}.json.gz"))
    dev_ms, n_launch, kernels = device_work(prof)

    # Stage by stage, with the inputs each stage gets in the pipeline; each
    # stage in its own profiler range and closed by a synchronise, so every
    # kernel it launched runs inside its range.
    opts = det._BatchOptions(board, True, 0.2, 160, 4, 40, 5, True, f, dev)

    @with_highest_precision
    def stages(images):
        walls = {}

        def run(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(f"stage.{name}"):
                r = fn()
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            return r

        nms, tpl, win = det._lowband_params(opts) if f > 1 else (4, 40, 5)
        if f > 1:
            frames = run("stack", lambda: np.stack(images))
            low = run("decimate", lambda: det._decimate_u8(frames, f))
            u8 = run("upload", lambda: torch.as_tensor(low, device=dev))
        else:
            u8 = run("upload", lambda: torch.as_tensor(np.stack(images), device=dev))
        gray = run("gray", lambda: det._gray_from_u8(u8))
        g01 = gray / 255.0
        run("corner_kernel", lambda: corner_cuda.corner_response_peaks(g01, 1.5, nms))
        xy, sc = run("candidates", lambda: det.find_corner_candidates(g01, 160, nms))
        grids, ok = run("device_ordering", lambda: det._order_grids_device(
            xy, sc, rows, cols, min_candidate_sep=float(nms + 1)))
        refined = run("refine", lambda: det.refine_corners_subpix(
            g01, grids.reshape(BATCH, -1, 2), win_size=win, max_drift=3.0
        ).reshape(grids.shape))
        s4 = run("anchors", lambda: det._batched_anchor_scores(gray, refined, tpl))
        found = run("host_finish", lambda: det._batch_finish(
            (gray, xy, sc, refined, s4, ok), BATCH, board, True, 0.2, tpl, win,
            nms_radius=nms, return_win=f > 1))
        if f > 1:
            found = run("promote", lambda: det._lowband_promote(frames, *found, opts, win))
        assert len(found) == BATCH, f"staged run detected {len(found)}/{BATCH}"
        return walls

    stage_walls = {}
    for b in batches[1:]:
        for name, w in stages(b).items():
            stage_walls.setdefault(name, []).append(w)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_s:
        stages(batches[1])
    spans = {}
    for e in prof_s.events():
        if e.name.startswith("stage.") and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name[6:]] = (e.time_range.start, e.time_range.end)
    stage_dev = {name: {"device_ms": 0.0, "launches": 0} for name in spans}
    for e in prof_s.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("stage."):
            continue
        for name, (a, b) in spans.items():
            if a <= e.time_range.start <= b:
                stage_dev[name]["device_ms"] += e.time_range.elapsed_us() / 1e3
                stage_dev[name]["launches"] += 1
                break

    report = {
        "device": card,
        "batch": BATCH,
        "coarse_downscale": f,
        "frame": list(tiled.shape[1:]),
        "board": list(board),
        "wall_s_runs": walls,
        "wall_s_median": statistics.median(walls),
        "frames_per_s_median": BATCH / statistics.median(walls),
        "profiled_wall_s": e2e_wall,
        "device_ms": dev_ms,
        "device_busy_share": dev_ms / 1e3 / e2e_wall,
        "n_kernel_launches": n_launch,
        "top_kernels": kernels[:15],
        "stages": {
            name: {
                "host_ms_runs": [1e3 * w for w in ws],
                "host_ms_median": 1e3 * statistics.median(ws),
                **stage_dev.get(name, {}),
            }
            for name, ws in stage_walls.items()
        },
    }
    print(f"end to end: median {1e3 * report['wall_s_median']:.2f} ms per batch "
          f"({report['frames_per_s_median']:.1f} frames/s; runs "
          + ", ".join(f"{1e3 * w:.2f}" for w in walls) + f" ms); profiled call "
          f"{1e3 * e2e_wall:.2f} ms, device busy {dev_ms:.3f} ms "
          f"({100 * report['device_busy_share']:.1f}%), {n_launch} launches")
    for k in kernels[:8]:
        print(f"  {k['device_ms']:8.3f} ms  x{k['count']:<5} {k['name'][:90]}")
    print("stages (host ms median of %d, synchronised; device ms and launches of one "
          "profiled pass):" % RUNS)
    for name, st in report["stages"].items():
        print(f"  {name:16s} host {st['host_ms_median']:8.3f} ms  device "
              f"{st.get('device_ms', float('nan')):8.3f} ms  launches {st.get('launches', 0)}")
    with open(os.path.join(args.out, f"profile_torch_detection{tag}.json"), "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
