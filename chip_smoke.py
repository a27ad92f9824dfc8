#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's paths at full size. Schur-LM bundle adjustment
(``lm_solve``) on the bench problem: 6 cameras x 922 frames x 35 board
points, the frames of BASELINE_PROBLEM.npz and the start of
``multicam_calibration_tpu_torch/data/bench_x0.npz``, with the bench's
options (bench.py:126-137). Chessboard detection
(``detect_chessboard_batch``) on 480x640 frames of a 5x7 board at batch 128,
the detection bench's configuration (scripts/bench_detection.py:23-25,
158-188), from the frames and JAX answers of
``multicam_calibration_tpu_torch/data/detect_frames.npz``. The calibration
pipeline (``calibrate`` -> ``bundle_adjust``) on the bench rig. Phases, one
line each:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``multicam_calibration_tpu_torch/csrc``, one
   nvcc per source, all started together; ptxas must report no spills for
   ``ba_blocks_kernel`` and ``ba_cost_kernel``;
3. each kernel against its plain PyTorch twin on the card, at the bench
   shape and at a ragged shape with zero-pose padded frames and a
   near-identity camera (the cost kernel's fragments and its f64 total, and
   a relaunch bit for bit), with timings of wrapper and twin, and from
   ``torch.profiler`` the kernels' own device time and the CUDA launches per
   call (at most 2 per ``ba_chunk_blocks`` and per ``ba_chunk_cost`` call);
4. a small ``lm_solve`` through the kernels against the plain path;
5. the bench problem on the default routes, both kernels (quality gate:
   final cost at or below scipy TRF's 12338.04, BASELINE_MEASURED.json),
   with block launches = ``n_iters`` and cost launches = ``nfev``; for the
   record the same solve with the torch per-try cost
   (``cost_impl="torch"``) and on the plain path (both impls "torch"), each
   held to the same gate;
6. the corner kernel's build: ptxas registers, stack and spills of every
   instantiation (radii 5, 11, 18, 27 and the runtime radius, with and
   without peaks; none may spill) and each one's dynamic shared memory;
7. the corner kernel against its plain twin on the card, bit for bit, at
   sigma 1.5, 2.0 (the runtime radius), 3.5, 6 and 9 with peaks and at sigma
   1.5 without, at a ragged shape and the bench shape (128 x 480 x 640);
   timed with peaks at sigma 1.5, 3.5, 6 and 9 and without at 1.5, beside
   the twin and, for the record, the SAME-convolution route
   (``corner_response(..., impl="conv")``, cuDNN) at sigma 1.5;
8. detection against the JAX package's stored answers: the same accepted
   frames, corners within 0.01 px, scores within 1e-3; the motion-blur
   frames must run the coarse sigma ladder (more than one kernel launch);
9. the full-width timed run: batch 128 (the clean frames tiled, with seeded
   +-2 noise as the detection bench), >= 10 timed calls after a warm-up,
   frames/s, detection rate 1.0, RMS corner error < 0.6 px, exactly one
   kernel launch per call; then one call of the public ``corner_response``;
10. the calibration pipeline's first stage on the bench rig (6 cameras x
   1000 frames, seed 11, noise 0.3 px, dropout 0.25,
   ``n_samples_for_intrinsics=50``, bench.py:71-81): the port's
   ``calibrate`` against the JAX package's own (``data/bench_x0.npz`` and
   ``data/bench_ba_ref.npz``, from ``scripts/export_torch_bench_x0.py`` and
   ``scripts/export_torch_bench_ba.py``), by ``start_gates``, as the CPU test
   tests/test_torch_initialize.py does: the same spanning tree, every
   intrinsic within 1e-6 relative; extrinsics and the bench frames' poses
   equal to JAX's (1e-6) except where the JAX package's own planar
   Gauss-Newton is chaotic (``pose_unstable``: its pose moves when the
   detections are scaled by 1 + 1e-15) and what such poses feed, those
   extrinsics within 2e-3 rad and 10 mm; the poses equal at the median
   frame; the bench problem's cost at the port's start within 1.5e-3 of
   the cost at JAX's; wall median of 5 calls after a warm-up, with each
   stage's share;
11. ``bundle_adjust`` with default options (the f32 recipe on CUDA, both
   kernels, the f64 polish on the card, pose repair on). Every call: RMSE <
   0.43 px, its f64 cost on its frames at most (1 + 1e-5) x the cost there
   at JAX's adjusted result (data/bench_ba_ref.npz; the port's poses on
   frames JAX did not select), which bounds the minimum from above, and
   kernel launches equal to what the solves it ran account for (block
   launches = ``n_iters`` x frame slabs of each solve on the kernel route,
   cost launches = their ``nfev``, + 1 after a pose repair). The main path
   runs from phase 10's outputs: the frames it selects equal to JAX's but
   for frames within 1% of the outlier threshold at JAX's start; both
   kernels against their twins at its mixed solve's start (all its frames,
   and the last 256-frame slab of the chunked layout); wall median of 5
   calls after a warm-up. From JAX's own ``calibrate`` outputs (the same
   start as the JAX run): ``use_frames`` equal to JAX's, final cost <=
   JAX's x (1 + 1e-5), under ``torch.profiler`` ``ba_blocks_kernel`` /
   ``ba_cost_kernel`` launches equal to those counts, the kernels against
   their twins at that start; for the record with ``frame_chunk=256`` and
   on the plain path, each under the same gates, and the mixed solve's
   own final cost (before the polish) of the kernel and chunked routes
   within 1e-5 of the plain route's.

12. the low-band path (``coarse_downscale`` 2 and 3) on phase 9's batches:
   the corner kernel against its twin bit for bit on the decimated frames
   (128 x 240 x 320 and 128 x 160 x 213, NMS radius 2) at sigma 1.5, 3.5, 6
   and 9, each timed beside its bound; on the 16 stored frames the decisions
   of the JAX package's low-band run (``data/detect_lowband.npz``, from
   ``scripts/export_torch_detect_lowband.py``), corners within 0.01 px;
   then 10 rounds of f = 1, 2, 3 on fresh batches of 128, interleaved in
   this process: frames/s (every call listed), rate 1.0, RMS corner error
   < 0.6 px, every corner within 0.25 px of the f = 1 call on the same
   batch, image bytes uploaded and corner-kernel launches per call;
13. ``detect_chessboard_batches`` over 8 batches of 128 (one of them empty)
   at f = 1 and 2: each dict bit-equal to a sequential
   ``detect_chessboard_batch`` call, ``{}`` for the empty batch; no
   dispatch synchronises (``torch.cuda.set_sync_debug_mode("error")``);
   frames/s of the streamed and the sequential run, interleaved; from one
   ``torch.profiler`` pass, how many ms of each batch's stage-1 device work
   ran while the previous batch's host half ran;
14. ``detect_chessboard`` at ``scale_factor`` 0.5 and 0.75 on the 16 stored
   frames: the JAX package's decisions, corners within 0.01 px; the resize
   of a stored frame within 1e-4 of JAX's; the corner kernel against its
   twin at the resized shapes (1 x 240 x 320, 1 x 360 x 480; NMS radius 4),
   timed;
15. the native lattice growth: ``csrc/lattice.cc`` built with the host
   compiler (its log printed); on the stored candidates native and numpy
   growth keep the same corner set and the same lattice up to symmetry;
   the host half's ms on the stored hard frames on each route;
   ``detect_chessboard_batch`` on the stored frames equal within 1e-5 on
   either route;
16. ``calibration_uncertainty`` in f64 at the JAX package's adjusted bench
   result (``data/bench_ba_ref.npz``): ``camera_sd`` and ``pose_sd`` within
   1e-8 relative of JAX's (``data/analysis_ref.npz``, from
   ``scripts/export_torch_analysis_ref.py``), ``dof`` equal, the root
   camera's extrinsic sd 0, timed; and timed at phase 19's window (64
   cameras, S 768 x 768);
17. ``triangulate`` (median, and refined with sd) on the bench rig's first
   48 frames at JAX's adjusted cameras: within 1e-8 relative + 1e-9 mm of
   JAX's; from phase 11's adjusted result, a median error < 1 mm to the true
   corners; a timed call at 6 x 1,048,576 points (20% of views missing, 1%
   corrupted, made from a seed on the card) with its peak device memory;
18. flatibration: JAX's RANSAC samples fed to
   ``_ransac_plane_fit_from_samples`` give its inlier mask exactly and its
   plane within 1e-10; ``flatibrate``, ``flip_z_axis`` and ``center_arena``
   within 1e-9 of JAX's; the port's own draw the same inliers; 108,000
   points x 256 hypotheses timed;
19. ``RollingCalibrator``: an f64 stream (6 cameras, window 32, 6 updates
   of 6, JAX's ``LMOptions``) with JAX's admitted / occupancy / ``n_iters``
   / window slots every update and costs and relative extrinsics within
   1e-8; then BASELINE.json config 4 at ``scripts/bench_streaming.py``'s
   shape (64 cameras, window 256, batches of 8) on the f32 recipe: the
   window filled, 12 timed updates, each launching ``ba_blocks_kernel``
   ``n_iters`` and ``ba_cost_kernel`` ``nfev`` times (and 2 more under the
   profiler, counted there, with each ``rolling.*`` range's share and the
   device busy time), both kernels against their twins at an update's
   start and timed at (64, 256, 35), the final cost at most 1.05 x the
   noise floor over the effective mask ``msk & active``, relative rotations
   within 0.02 rad of the truth.

Then one line naming the host packages this machine has for the modules
not ported yet (h5py, yaml, pandas, cv2, libavformat; it gates nothing),
one JSON line describing each kernel, with its bound on this card
(the larger of bytes over 3.35 TB/s and operations over the peak rate of
their type: 67 TFLOP/s f32, 34 TFLOP/s f64, NVIDIA's H100 SXM data sheet),
and last the device line. Any failed check raises, and the script exits
non-zero. It needs a CUDA device and the repository around it; it imports
no JAX.
"""
import concurrent.futures
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCIPY_TRF_COST = 12338.04  # BASELINE_MEASURED.json: the bench's quality gate
DATA = os.path.join(HERE, "multicam_calibration_tpu_torch", "data")
# The bench rig (bench.py:71-81).
RIG = dict(n_cameras=6, n_frames=1000, noise_px=0.3, dropout=0.25, seed=11)
N_SAMPLES_FOR_INTRINSICS = 50
# Phase 10's tolerances against the JAX package's calibrate
# (tests/test_torch_initialize.py::test_calibrate_reproduces_the_bench_start).
# SAME_ABS: an extrinsic, a pose "equal to JAX's" (rad, mm; see start_gates).
INTRINSICS_RTOL, EXT_ROT_RAD, EXT_TRANS_MM, SAME_ABS, X0_COST_RTOL = (
    1e-6, 2e-3, 10.0, 1e-6, 1.5e-3)
BA_COST_RTOL, BA_RMSE_PX, SELECT_MARGIN = 1e-5, 0.43, 0.01  # phase 11's gates
CHUNK = 256  # phase 11's frame_chunk
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "ba_blocks_kernel": ("multicam_calibration_tpu_torch/csrc/ba_kernels.cu",
                         "multicam_calibration_tpu/ops/ba_pallas.py:253"),
    "ba_cost_kernel": ("multicam_calibration_tpu_torch/csrc/ba_kernels.cu",
                       "multicam_calibration_tpu/ops/ba_pallas.py:630"),
    "corner_peaks_kernel": ("multicam_calibration_tpu_torch/csrc/corner_kernels.cu",
                            "multicam_calibration_tpu/ops/pallas_kernels.py:139"),
    "corner_response_kernel": ("multicam_calibration_tpu_torch/csrc/corner_kernels.cu",
                               "multicam_calibration_tpu/ops/pallas_kernels.py:44"),
}
LOWBAND_F = (2, 3)  # scripts/bench_detection.py:211
SCALES = (0.5, 0.75)
STREAM_BATCHES, EMPTY_AT = 8, 3  # phase 13: 8 batches, the 4th empty
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 and f64 flop/s outside
# the tensor cores.
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12
BATCH, TIMED_CALLS = 128, 10  # scripts/bench_detection.py: batch 128
# The bench's LMOptions (bench.py:126-137) as JAX field values.
BENCH_JAX_OPTIONS = dict(
    jac_dtype="float32", block_dtype="float32", cost_dtype="float32",
    solve_dtype="float32", lambda_escalation=3.0, grad_dtype="float32",
    gtol_rel=1e-6,
)


# Phases 16-19. The inputs of the parity checks are made here from seeds;
# scripts/export_torch_analysis_ref.py makes the same ones for the JAX
# package and stores its answers in data/analysis_ref.npz.
TRI_FRAMES = 48  # phase 17: the bench rig's first 48 frames, 35 corners each
TRI_BIG = dict(n_points=1 << 20, missing=0.2, corrupt=0.01, seed=3)
FLOOR = dict(n=400, seed=5)  # phase 18's parity floor (tests/test_io_flatibration_viz.py:79-85)
FLOOR_BIG, FLOOR_HYP = 108_000, 256  # an hour of frames at 30 fps, 256 hypotheses
# Phase 19's f64 check: 6 updates of 6 frames into a window of 32.
STREAM_F64 = dict(n_cameras=6, n_frames=36, seed=11, window=32, batch=6, iters=3,
                  protect=8)
# Phase 19: BASELINE.json config 4 at scripts/bench_streaming.py:16-19's shape.
STREAM = dict(n_cameras=64, window=256, batch=8, timed=12, seed=11)
STREAM_PROFILED = 2  # updates under torch.profiler after the timed ones
PROFILE_TRIES = 3  # profiler sessions for one measurement, see profiled()
NOISE_PX = 0.3
# Phases 16-19's tolerances against JAX's stored answers (f64 both sides),
# and phase 19's camera gate (tests/test_streaming.py:52).
UNC_RTOL, TRI_RTOL, TRI_ATOL_MM, PLANE_ATOL, FLAT_ATOL = 1e-8, 1e-8, 1e-9, 1e-10, 1e-9
STREAM_RTOL, STREAM_ROT_RAD = 1e-8, 0.02


def floor_points(n, seed):
    """Floor points on the plane z = 0.1 x - 0.2 y + 30 (1 mm noise), 10%
    raised by 50-200 mm (animal body points)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-300, 300, size=(n, 2))
    z = 0.1 * xy[:, 0] - 0.2 * xy[:, 1] + 30 + rng.standard_normal(n)
    pts = np.column_stack([xy, z])
    out = rng.choice(n, n // 10, replace=False)
    pts[out, 2] += rng.uniform(50, 200, size=len(out))
    return pts, out


def triangulation_views(rig, frames):
    """The rig's detections of ``frames`` as triangulate's per-camera
    (n_points, 2) lists (NaN where unseen) and the true points."""
    from multicam_calibration_tpu_torch.synthetic import _t6_to_T

    uvs = rig.all_calib_uvs[:, :frames].reshape(rig.n_cameras, -1, 2)
    T = np.stack([_t6_to_T(p) for p in rig.calib_poses[:frames]])
    truth = np.einsum("fij,nj->fni", T[:, :3, :3], rig.calib_objpoints) + T[:, None, :3, 3]
    return list(uvs), truth.reshape(-1, 3)


def stream_start(rig, seed):
    """Mount drift as tests/test_streaming.py:25-34 makes it: ~0.3 degree
    rotations and ~3 mm shifts on every camera but the first."""
    rng = np.random.default_rng(seed)
    ext = rig.all_extrinsics.copy()
    ext[:, :3] += rng.normal(0, 0.005, (len(ext), 3))
    ext[:, 3:] += rng.normal(0, 3.0, (len(ext), 3))
    ext[0] = rig.all_extrinsics[0]
    return ext, [(K.copy(), d.copy()) for K, d in rig.all_intrinsics]


def is_annotation(event):
    """A profiler range the code opened (``record_function``), which the
    trace also mirrors on the device timeline; not device work."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith(
        ("rolling.", "lm_solve."))


def relative_extrinsics(ext):
    """Each camera's transform relative to camera 0 (6-vectors): the
    gauge-free part of a rig's extrinsics."""
    from multicam_calibration_tpu_torch.synthetic import _T_to_t6, _t6_to_T

    T0_inv = np.linalg.inv(_t6_to_T(np.asarray(ext)[0]))
    return np.stack([_T_to_t6(_t6_to_T(e) @ T0_inv) for e in np.asarray(ext)])


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over their peak rate; ``ops`` is [(count, flop/s), ...]."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / rate for n, rate in ops)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ba_bounds(C, F, N, n_obs):
    """Bounds of the two BA kernels at one shape. Bytes: the parameters
    (C x 12, F x 6 f64), board points, observations (f64) and mask (u8)
    read once, the f32 outputs written once. Operations, counted for the
    observed points only: the f64 prediction chain, ~60 flops per point
    (rotate and translate twice, project, distort, scale), and for the block
    build the 189 distinct normal-block outputs, each a multiply-add over
    the point's two residual rows (756 f32 flops per point). The rotations
    of C + F parameter vectors are ~100 flops each and left out."""
    inputs = C * 12 * 8 + F * 6 * 8 + N * 3 * 8 + C * F * N * (2 * 8 + 1)
    blocks_out = 4 * (C * 144 + F * 36 + C * F * (72 + 12 + 6 + 1))
    chain = (60 * n_obs, F64_FLOPS)
    return {
        "ba_blocks_kernel": bound(inputs + blocks_out, [chain, (756 * n_obs, F32_FLOPS)]),
        "ba_cost_kernel": bound(inputs + 4 * C * F + 8, [chain, (4 * n_obs, F32_FLOPS)]),
    }


def corner_bound(B, H, W, sigma, nms, peaks):
    """Bound of the corner kernel on (B, H, W): 4 B read and 4 B (+1 B of
    peak) written per pixel; per pixel 2 (2 rg + 1) - 1 flops for each
    Gaussian pass, 12 for the stencil and response, 4 nms + 2 for the window
    max and the compare."""
    rg = int(3 * sigma + 0.5)
    px = B * H * W
    per_px = 2 * (2 * (2 * rg + 1) - 1) + 12 + (4 * nms + 2 if peaks else 0)
    return bound(px * (4 + 4 + (1 if peaks else 0)), [(px * per_px, F32_FLOPS)])


def bench_problem(torch, device):
    """The bench problem as device tensors: (cam0, poses0, obs, mask, objp)."""
    import multicam_calibration_tpu_torch as mct

    x0 = np.load(os.path.join(HERE, "multicam_calibration_tpu_torch", "data", "bench_x0.npz"))
    prob = np.load(os.path.join(HERE, "BASELINE_PROBLEM.npz"))
    check(np.array_equal(x0["use_frames"], prob["use_frames"]),
          "bench_x0.npz frames differ from BASELINE_PROBLEM.npz")
    rig = mct.make_synthetic_rig(
        n_cameras=int(prob["n_cameras"]), n_frames=int(prob["n_frames"]),
        noise_px=0.3, dropout=0.25, seed=int(prob["seed"]),
    )
    obs_np = rig.all_calib_uvs[:, prob["use_frames"]]
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return (
        as_t(x0["cam0"]), as_t(x0["poses0"]), as_t(np.nan_to_num(obs_np)),
        as_t(~np.isnan(obs_np).any(-1)), as_t(rig.calib_objpoints),
    )


def describe_build(built):
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return f"{built.path.name} in {built.build_s:.2f} s; " + " | ".join(ptxas)


def ptxas_of(log, kernel):
    """What ptxas reported for ``kernel`` in a build log: registers, stack
    frame bytes and spill store / load bytes."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            text = []
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                text.append(nxt)
            text = " ".join(text)
            regs = re.search(r"Used (\d+) registers", text)
            sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads", text)
            if regs and sp:
                return {"registers": int(regs[1]), "stack_bytes": int(sp[1]),
                        "spill_stores": int(sp[2]), "spill_loads": int(sp[3])}
    raise AssertionError(f"no ptxas report for {kernel}:\n{log}")


def profiled(torch, fn, what):
    """(fn(), the profiler) of one run of fn under torch.profiler (CPU and
    CUDA), synchronised before the session stops. A session in which the
    profiler recorded no device work at all lost its trace, not the work:
    it is reported and fn is run again, in PROFILE_TRIES sessions at most."""
    from torch.profiler import ProfilerActivity, profile

    for k in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA and not is_annotation(e)
               for e in prof.events()):
            return out, prof
        log("profiler", f"{what}: session {k + 1} recorded no device work, run again")
    raise AssertionError(f"{what}: torch.profiler recorded no device work in "
                         f"{PROFILE_TRIES} sessions")


def profile_calls(torch, fn, calls=10):
    """(CUDA launches per call, device ms per call, {kernel: device us per
    call}) of fn() over ``calls`` calls under torch.profiler, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    _, prof = profiled(torch, lambda: [fn() for _ in range(calls)], "profile_calls")
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {}
    for e in dev:
        key = re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name)
        per[key] = per.get(key, 0.0) + e.time_range.elapsed_us() / calls
    return len(dev) / calls, sum(per.values()) / 1e3, per


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() in ms over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_blocks(got, ref):
    """Kernel vs twin block fragments at the kernel-parity tolerances;
    returns (max abs error over all outputs, per-output scaled errors)."""
    names = ("U", "V", "W", "g_cam", "g_pose", "cost")
    max_abs, scaled = 0.0, {}
    for name, a, b in zip(names, got, ref):
        a, b = a.double(), b.double()
        check(bool(a.isfinite().all()), f"{name}: non-finite kernel output")
        err = float((a - b).abs().max())
        max_abs = max(max_abs, err)
        mag = float(b.abs().max())
        if name in ("U", "V", "W"):
            tol = 2e-5 * mag
        elif name == "cost":
            tol = 3e-5 * float(b.sum().abs())  # the total, compared below
            err = float((a.sum() - b.sum()).abs())
        else:
            tol = 3e-5 * max(1.0, mag)
        scaled[name] = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
        check(err <= tol, f"{name}: |kernel - twin| {err:.3e} > tol {tol:.3e}")
    return max_abs, scaled


def compare_cost(got, ref, again):
    """Cost kernel vs twin: fragments at rtol 2e-5 atol 1e-7; the kernel's f64
    total within rtol 1e-12 of the f64 sum of its own fragments and within
    3e-5 of the twin's; ``again``, a relaunch, bit-identical. Returns (max
    abs fragment error, relative error of the total against the f64 sum)."""
    (frags, total), (ref_frags, ref_total) = got, ref
    a, b = frags.double(), ref_frags.double()
    check(bool(a.isfinite().all()) and bool(total.isfinite()), "cost kernel: non-finite output")
    tol = 1e-7 + 2e-5 * b.abs()
    check(bool(((a - b).abs() <= tol).all()), "cost kernel: fragments out of rtol 2e-5")
    own = float(a.sum())
    rel = abs(float(total) - own) / abs(own)
    check(rel <= 1e-12, f"cost kernel: total {float(total)!r} vs f64 sum of fragments {own!r}")
    check(abs(float(total) - float(ref_total)) <= 3e-5 * abs(float(ref_total)),
          f"cost kernel: total {float(total)} vs twin {float(ref_total)}")
    check(frags.equal(again[0]) and total.equal(again[1]),
          "cost kernel: a relaunch is not bit-identical")
    return float((a - b).abs().max()), rel


def compare_corner(torch, gray, sigma, nms, peaks):
    """Kernel vs twin on one input, bit for bit (the kernel rounds every
    multiply and add as the twin does, in the same order): resp equal, peak
    equal to the twin's and to the NMS of the kernel's own response (away
    from the border, where the window lies in the image); a relaunch gives
    the same bits. Returns max |resp_kernel - resp_twin| (0.0)."""
    import torch.nn.functional as F

    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    if peaks:
        resp, peak = cc.corner_response_peaks(gray, sigma, nms)
        again = cc.corner_response_peaks(gray, sigma, nms)
        resp_t, peak_t = cc.corner_response_peaks_reference(gray, sigma, nms)
    else:
        resp, again = cc.corner_response_fused(gray, sigma), (cc.corner_response_fused(gray, sigma),)
        resp_t = cc.corner_response_fused_reference(gray, sigma)
    torch.cuda.synchronize()
    check(bool(resp.isfinite().all()), f"sigma {sigma}: non-finite response")
    err = float((resp - resp_t).abs().max())
    check(torch.equal(resp, resp_t), f"sigma {sigma}: kernel != twin, max |diff| {err:.3e}")
    check(torch.equal(again[0], resp), f"sigma {sigma}: a relaunch is not bit-identical")
    if peaks:
        own = cc.peaks_of(F.pad(resp, (nms,) * 4, value=float("-inf")), nms)
        inner_n = (slice(None), slice(nms, -nms), slice(nms, -nms))
        check(torch.equal(peak[inner_n], own[inner_n]), f"sigma {sigma}: peaks != NMS of own response")
        check(torch.equal(peak, peak_t) and torch.equal(again[1], peak),
              f"sigma {sigma}: peaks != twin's peaks or a relaunch's")
    return err


def detect_phases(torch, dev, corner_build, launches, errs, times, bounds):
    """Phases 6-9: the detection path; fills the corner kernels' entries of
    launches / errs / times / bounds."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.detection import detector
    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    # 6. build: every instantiation of the template, none may spill
    built = corner_build.result()
    lib = cc.bind(built.lib)
    log("6 build", f"{built.path.name} in {built.build_s:.2f} s")
    for peaks in (1, 0):
        for rg in cc.RADII + (0,):
            ptxas = ptxas_of(built.log, f"corner_kernelILb{peaks}ELi{rg}EE")
            name = f"corner_kernel<{bool(peaks)}, {rg}>".lower()
            check(ptxas["spill_stores"] == ptxas["spill_loads"] == 0, f"{name} spills: {ptxas}")
            smem = lib.corner_smem_bytes(rg or 6, 4, peaks)
            log("6 ptxas", f"{name}: " + ", ".join(f"{k} {v}" for k, v in ptxas.items())
                + f", dynamic shared memory {smem} B at rg {rg or 6}, nms 4")

    # 7. kernel vs twin
    nms = 4
    gen = torch.Generator(device=dev).manual_seed(0)
    d = np.load(os.path.join(HERE, "multicam_calibration_tpu_torch", "data", "detect_frames.npz"))
    frames = d["frames"]
    board = tuple(int(v) for v in d["board_shape"])
    clean = np.nonzero(d["kind"] == "clean")[0]
    reps = -(-BATCH // len(clean))
    bench_gray = torch.as_tensor(np.concatenate([frames[clean]] * reps)[:BATCH], device=dev)
    bench_gray = bench_gray.float() / 255.0
    shapes = {"ragged": torch.rand((3, 130, 131), generator=gen, device=dev),
              "bench": bench_gray}
    errs["corner_peaks_kernel"] = errs["corner_response_kernel"] = 0.0
    for label, g in shapes.items():
        msg = []
        for sigma in (1.5, 2.0, 3.5, 6.0, 9.0):  # 2.0: the runtime-radius instantiation
            e = compare_corner(torch, g, sigma, nms, True)
            errs["corner_peaks_kernel"] = max(errs["corner_peaks_kernel"], e)
            msg.append(f"peaks sigma {sigma} max|err| {e:.3e}")
        e = compare_corner(torch, g, 1.5, nms, False)
        errs["corner_response_kernel"] = max(errs["corner_response_kernel"], e)
        msg.append(f"no-peaks sigma 1.5 max|err| {e:.3e}")
        log(f"7 parity {label}", f"{tuple(g.shape)}: " + "; ".join(msg))
    B, H, W = bench_gray.shape
    timing = {sigma: cuda_ms(torch, lambda: cc.corner_response_peaks(bench_gray, sigma, nms))
              for sigma in (1.5, 3.5, 6.0, 9.0)}
    plain = {sigma: cuda_ms(torch, lambda: cc.corner_response_peaks_reference(bench_gray, sigma, nms), 5)
             for sigma in (1.5, 9.0)}
    times["corner_peaks_kernel"] = (timing[1.5], plain[1.5])
    times["corner_response_kernel"] = (
        cuda_ms(torch, lambda: cc.corner_response_fused(bench_gray, 1.5)),
        cuda_ms(torch, lambda: cc.corner_response_fused_reference(bench_gray, 1.5), 5))
    conv_ms = cuda_ms(torch, lambda: detector.corner_response(bench_gray, 1.5, impl="conv"))
    bounds["corner_peaks_kernel"] = corner_bound(B, H, W, 1.5, nms, True)
    bounds["corner_response_kernel"] = corner_bound(B, H, W, 1.5, nms, False)
    peaks_ms = []
    for sigma, ms in timing.items():
        b = corner_bound(B, H, W, sigma, nms, True)
        twin = f", twin {plain[sigma]:.4f}" if sigma in plain else ""
        peaks_ms.append(f"sigma {sigma} {ms:.4f}{twin} (bound {b[0]:.4f}, {b[1]}; {ms / b[0]:.1f}x)")
    log("7 timing", f"{(B, H, W)}, ms per call: peaks " + "; ".join(peaks_ms)
        + f"; no-peaks sigma 1.5 {times['corner_response_kernel'][0]:.4f}, twin "
        f"{times['corner_response_kernel'][1]:.4f} (bound {bounds['corner_response_kernel'][0]:.4f}, "
        f"{bounds['corner_response_kernel'][1]}); SAME-convolution route (cuDNN, several calls) "
        f"sigma 1.5 {conv_ms:.4f}")
    del shapes, bench_gray

    # 8. detection against the JAX package's stored answers
    def detect(images):
        before = cc.corner_response_peaks.launches
        out = mct.detect_chessboard_batch(list(images), board_shape=board, device=dev)
        return out, cc.corner_response_peaks.launches - before

    got, n_all = detect(frames)
    acc = np.nonzero(d["accepted"])[0]
    check(sorted(got) == sorted(int(i) for i in acc),
          f"accepted frames {sorted(got)} != JAX's {acc.tolist()}")
    du = ds = 0.0
    for j, i in enumerate(acc):
        du = max(du, float(np.abs(got[int(i)][0] - d["uvs"][j]).max()))
        ds = max(ds, float(np.abs(got[int(i)][1] - d["scores"][j]).max()))
    check(du <= 0.01, f"corners differ from JAX's by {du:.4f} px")
    check(ds <= 1e-3, f"anchor scores differ from JAX's by {ds:.2e}")
    ladder = np.nonzero(d["needs_ladder"])[0]
    check(len(ladder) > 0, "no stored frame needs the coarse ladder")
    got_l, n_ladder = detect(frames[ladder])
    check(sorted(got_l) == list(range(len(ladder))), "coarse-ladder frames not all detected")
    check(n_ladder > 1, f"coarse-ladder frames launched the kernel {n_ladder} times")
    log("8 parity", f"{len(frames)} frames ({', '.join(sorted(set(d['kind'].tolist())))}): "
        f"accepted {len(got)}/{len(frames)} as JAX; max |corner diff| {du:.2e} px, max |score "
        f"diff| {ds:.2e}; kernel launches {n_all}; the {len(ladder)} coarse-ladder frames "
        f"alone: {n_ladder} launches")

    # 9. the full-width timed run: the clean frames tiled to batch 128 with
    # seeded +-2 noise (scripts/bench_detection.py:176-188), fresh per call
    batches, gt = noisy_batches(d, TIMED_CALLS + 1, seed=7)
    detect(batches[0])  # warm-up
    cc.corner_response_peaks.launches = 0
    cc.corner_response_fused.launches = 0
    walls, n_launch, n_det, sq = [], [], 0, []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, n = detect(b)
        walls.append(time.perf_counter() - t0)
        n_launch.append(n)
        n_det += len(out)
        for i, (uvs, _) in out.items():
            sq.append(((uvs - gt[i]) ** 2).sum(-1))
    resp = mct.corner_response(torch.as_tensor(batches[0], device=dev).float() / 255.0)
    torch.cuda.synchronize()
    check(tuple(resp.shape) == (BATCH,) + frames.shape[1:] and bool(resp.isfinite().all()),
          "corner_response: bad output")
    launches["corner_peaks_kernel"] = cc.corner_response_peaks.launches
    launches["corner_response_kernel"] = cc.corner_response_fused.launches
    rate = n_det / (BATCH * TIMED_CALLS)
    rms = float(np.sqrt(np.concatenate(sq).mean())) if sq else float("inf")
    fps = [BATCH / w for w in walls]
    check(rate == 1.0, f"detection rate {rate} on clean frames")
    check(rms < 0.6, f"RMS corner error {rms:.4f} px")
    check(n_launch == [1] * TIMED_CALLS, f"kernel launches per call {n_launch}")
    check(launches["corner_response_kernel"] == 1, "corner_response did not launch its kernel")
    log("9 detection", f"batch {BATCH} x {frames.shape[1]}x{frames.shape[2]}, board {board}: "
        f"median {statistics.median(fps):.1f} frames/s (runs " + ", ".join(f"{f:.1f}" for f in fps)
        + f"); detection rate {rate:.3f}; RMS corner error {rms:.4f} px; kernel launches per "
        f"call {n_launch[0]}; public corner_response: 1 launch")


def timed(torch, fn):
    """(fn(), host seconds) from a synchronised start to a synchronised end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def walls_text(walls):
    return (f"median {statistics.median(walls):.4f} s (runs "
            + ", ".join(f"{w:.4f}" for w in walls) + ")")


def stage_text(stage_times, calls):
    """Mean seconds per call of each metrics stage timer."""
    return ", ".join(f"{k} {v / calls:.4f}" for k, v in stage_times.items())


def unstable_cameras(tree, unstable):
    """Cameras whose extrinsics may differ from JAX's: one with a camera-frame
    in ``unstable`` (JAX's ``pose_unstable``, (C, F)), one whose tree parent
    has one (their pairwise median may take it), and their descendants."""
    bad = set(np.nonzero(unstable.any(1))[0].tolist())
    out = set()
    for parent, child in tree:  # parents come first
        if parent in out or parent in bad or child in bad:
            out.add(child)
    return out


def start_gates(torch, dev, rig, cal, ref, x0):
    """Phase 10's gates on ``calibrate``'s outputs against the JAX package's
    (``ref``: data/bench_ba_ref.npz, ``x0``: data/bench_x0.npz), the same on
    the card and in the CPU test. Returns what they measured.

    The undamped planar Gauss-Newton leaves its basin, or lands in another
    one, on the camera-frames of ``ref["pose_unstable"]`` (JAX against itself
    with the detections scaled by 1 + 1e-15); there no two implementations
    return the same pose, and the extrinsics and consensus medians that take
    such a pose move. So: the same tree; every intrinsic within
    INTRINSICS_RTOL; extrinsics equal (SAME_ABS) but for cameras that
    :func:`unstable_cameras` allows, and those within EXT_ROT_RAD /
    EXT_TRANS_MM; the bench frames' poses equal (SAME_ABS) but for frames
    seen by a camera whose extrinsics moved or holding an unstable
    camera-frame, and equal at the median frame; the bench problem's cost
    at the port's start within X0_COST_RTOL of the cost at JAX's."""
    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays

    ext, intr, poses, tree = cal
    check([tuple(e) for e in ref["tree"].tolist()] == list(tree),
          f"spanning tree {tree} != JAX's {ref['tree'].tolist()}")
    cam0, jcam = _params_to_arrays(ext, intr), x0["cam0"]
    intr_rel = float((np.abs(cam0[:, :6] - jcam[:, :6]) / np.abs(jcam[:, :6])).max())
    check(intr_rel <= INTRINSICS_RTOL, f"intrinsics differ from JAX's by {intr_rel:.3e} relative")
    ext_err = np.abs(cam0[:, 6:] - jcam[:, 6:])
    rot, trans = float(ext_err[:, :3].max()), float(ext_err[:, 3:].max())
    check(rot <= EXT_ROT_RAD and trans <= EXT_TRANS_MM,
          f"extrinsics differ from JAX's by {rot:.3e} rad, {trans:.3e} mm")
    moved = np.nonzero(ext_err.max(-1) > SAME_ABS)[0]
    allowed = unstable_cameras(tree, ref["pose_unstable"])
    check(set(moved.tolist()) <= allowed, f"extrinsics of cameras {moved.tolist()} differ from "
          f"JAX's; only {sorted(allowed)} take unstable poses")
    uf = x0["use_frames"]
    pose_err = np.abs(np.nan_to_num(poses[uf]) - x0["poses0"]).max(-1)
    seen = ~np.isnan(rig.all_calib_uvs[:, uf]).any((-1, -2))  # (C, F) fully detected
    explained = seen[moved].any(0) | (seen & ref["pose_unstable"][:, uf]).any(0)
    differ = pose_err > SAME_ABS
    stray = np.nonzero(differ & ~explained)[0]
    check(not len(stray), f"bench frames {uf[stray].tolist()} differ from JAX's poses by "
          f"{pose_err[stray].max(initial=0.0):.3e}, seen by no moved camera nor unstable pose")
    check(float(np.median(pose_err)) <= SAME_ABS,
          f"median pose difference {np.median(pose_err):.3e}")
    obs_np = rig.all_calib_uvs[:, uf]
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    problem = (as_t(np.nan_to_num(obs_np)), as_t(~np.isnan(obs_np).any(-1)),
               as_t(rig.calib_objpoints))
    cost_at = lambda cam, p: float(lm_core.compute_cost(  # noqa: E731
        as_t(cam), as_t(p), *problem, lm_core.LMOptions()))
    c_port, c_jax = cost_at(cam0, np.nan_to_num(poses[uf])), cost_at(jcam, x0["poses0"])
    check(abs(c_port - c_jax) <= X0_COST_RTOL * c_jax,
          f"cost at the port's start {c_port} vs JAX's {c_jax}")
    return dict(intr_rel=intr_rel, rot=rot, trans=trans, moved=moved.tolist(),
                allowed=sorted(allowed), pose_err=pose_err, differ=int(differ.sum()),
                explained=int(explained.sum()), frames=len(uf), c_port=c_port, c_jax=c_jax)


def calibrate_phase(torch, dev):
    """Phase 10: the port's calibrate on the bench rig against JAX's."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    ref = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
    x0 = np.load(os.path.join(DATA, "bench_x0.npz"))
    rig = mct.make_synthetic_rig(**RIG)
    call = lambda: mct.calibrate(  # noqa: E731
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
        n_samples_for_intrinsics=N_SAMPLES_FOR_INTRINSICS, device=dev)
    out, warm = timed(torch, call)
    metrics.stage_times.clear()
    walls = [timed(torch, call)[1] for _ in range(5)]
    stages = stage_text(metrics.stage_times, len(walls))
    g = start_gates(torch, dev, rig, out, ref, x0)
    pe = g["pose_err"]
    log("10 calibrate", f"{RIG['n_cameras']} x {RIG['n_frames']} x {rig.calib_objpoints.shape[0]}, "
        f"n_samples_for_intrinsics {N_SAMPLES_FOR_INTRINSICS}: tree {out[3]} as JAX; intrinsics "
        f"max rel diff {g['intr_rel']:.3e}; extrinsics max |diff| {g['rot']:.3e} rad, "
        f"{g['trans']:.3e} mm, cameras off JAX's {g['moved']} (allowed {g['allowed']}: "
        f"{int(ref['pose_unstable'].sum())} unstable camera-frames in JAX); poses at the "
        f"{g['frames']} bench frames: {g['differ']} differ (all among the {g['explained']} seen by "
        f"a moved camera or holding an unstable pose), median max|diff| {np.median(pe):.3e}, 90th "
        f"percentile {np.percentile(pe, 90):.3e}, max {pe.max():.3e}; bench cost at the start "
        f"{g['c_port']:.4f} vs JAX's {g['c_jax']:.4f} (rel "
        f"{(g['c_port'] - g['c_jax']) / g['c_jax']:+.2e}); wall " + walls_text(walls)
        + f", warm-up {warm:.4f} s; stages per call: {stages}")
    return rig, out


def selection_ratios(torch, dev, rig, ext, intr, poses):
    """select_ba_frames' statistic at a start: {frame: worst per-camera mean
    reprojection error / outlier threshold} over the >= 2-camera frames."""
    import warnings

    import multicam_calibration_tpu_torch as mct

    uvs = rig.all_calib_uvs
    use = np.nonzero((~np.isnan(uvs).any((-1, -2))).sum(0) > 1)[0]
    pred = mct.predict_calib_uvs(ext, intr, rig.calib_objpoints, np.asarray(poses)[use],
                                 device=dev).cpu().numpy()
    err = np.linalg.norm(uvs[:, use] - pred, axis=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        worst = np.nan_to_num(np.nanmax(np.nanmean(err, axis=-1), axis=0))
        thresh = 5 * np.nanmedian(err)
    return dict(zip(use.tolist(), (worst / thresh).tolist()))


def hold_kernels_at(torch, start, opts, errs):
    """Both BA kernels against their twins at a solve's own start (cam,
    poses, obs, mask, objp): over all its frames and, when it has more than
    CHUNK, on the last frame slab of CHUNK (zero-pose padded) as the chunked
    layout cuts it, at phase 3's tolerances. Returns a text for the log."""
    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.ops import ba_cuda

    cam, poses, obs, mask, objp = start
    cam64, pose64, objp64 = lm_core._kernel_params(cam, poses, objp)
    chunked = dataclasses.replace(opts, frame_chunk=CHUNK)
    prepared = lm_core._prepare(obs, mask, chunked)
    kw = dict(f_scale=opts.f_scale, loss_linear=opts.loss == "linear")
    shapes = {f"C={cam64.shape[0]} F={pose64.shape[0]}":
              (cam64, pose64, prepared.obs, prepared.msk, objp64)}
    chunking = lm_core._chunking(chunked, pose64.shape[0])
    if chunking is not None:  # F > CHUNK
        chunk, pad, _ = chunking
        last = lm_core._pad_frames(pose64, 0, pad)[-chunk:].contiguous()
        shapes[f"last slab of {chunk} ({pad} padded)"] = (cam64, last, *prepared.slabs[-1],
                                                          objp64)
    out = []
    for what, args in shapes.items():
        err, scaled = compare_blocks(ba_cuda.ba_chunk_blocks(*args, **kw),
                                     ba_cuda.ba_chunk_blocks_reference(*args, **kw))
        cerr, trel = compare_cost(ba_cuda.ba_chunk_cost(*args, **kw),
                                  ba_cuda.ba_chunk_cost_reference(*args, **kw),
                                  ba_cuda.ba_chunk_cost(*args, **kw))
        errs["ba_blocks_kernel"] = max(errs["ba_blocks_kernel"], err)
        errs["ba_cost_kernel"] = max(errs["ba_cost_kernel"], cerr)
        out.append(f"{what}: blocks max|err| {err:.3e} (worst err/tol "
                   f"{max(scaled.values()):.2e}), cost fragments max|err| {cerr:.3e}, total rel "
                   f"{trel:.1e}")
    return "; ".join(out)


def bundle_adjust_phase(torch, dev, cal, errs):
    """Phase 11: the port's bundle_adjust, from phase 10's outputs (the main
    path) and from JAX's calibrate outputs (the same start as JAX's run)."""
    from types import SimpleNamespace

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.models import bundle_adjustment, lm_core
    from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays
    from multicam_calibration_tpu_torch.ops import ba_cuda
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    rig, (ext, intr, poses, _) = cal
    ref = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
    jax_start = (ref["ext"], list(zip(ref["K"], ref["dist"])), ref["poses"])
    jax_cam = _params_to_arrays(ref["adj_ext"], list(zip(ref["adj_K"], ref["adj_dist"])))
    jax_poses = dict(zip(ref["use_frames"].tolist(), ref["adj_poses"]))
    objp = torch.as_tensor(rig.calib_objpoints, device=dev)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    solves = []  # (the five arrays, options, info) of every lm_solve a call runs
    lm_solve = bundle_adjustment.lm_solve

    def recording_lm_solve(*args, **kwargs):
        out = lm_solve(*args, **kwargs)
        solves.append((args[:5], args[5], out[2]))
        return out

    def f64_costs(uf, a_ext, a_intr, a_poses):
        """bundle_adjust's f64 cost on ``uf`` at the port's result and at
        JAX's (its cameras, its poses; the port's on frames it did not
        select): JAX's point bounds the port's minimum from above."""
        obs_np = rig.all_calib_uvs[:, uf]
        problem = (as_t(np.nan_to_num(obs_np)), as_t(~np.isnan(obs_np).any(-1)), objp)
        opts = lm_core.LMOptions(ftol=1e-4, loss="soft_l1", f_scale=1.0)
        q = np.stack([jax_poses.get(f, p) for f, p in zip(uf.tolist(), a_poses)])
        return [float(lm_core.compute_cost(as_t(c), as_t(p), *problem, opts))
                for c, p in ((_params_to_arrays(a_ext, a_intr), a_poses), (jax_cam, q))]

    def run(start, **kw):
        """One bundle_adjust, checked: its wrapper calls equal what the
        solves it ran account for, RMSE < BA_RMSE_PX, and its f64 cost at
        most JAX's point's on its frames x (1 + BA_COST_RTOL)."""
        solves.clear()
        before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
        s_ext, s_intr, s_poses = start
        (a_ext, a_intr, a_poses, uf, info), wall = timed(torch, lambda: mct.bundle_adjust(
            rig.all_calib_uvs, s_ext, s_intr, rig.calib_objpoints, s_poses, verbose=False,
            device=dev, **kw))
        nb = ba_cuda.ba_chunk_blocks.launches - before[0]
        nc = ba_cuda.ba_chunk_cost.launches - before[1]
        eb = ec = 0
        for k, (_, o, sinfo) in enumerate(solves):
            if lm_core._cuda_block_build(o, torch.float64, objp):
                chunking = lm_core._chunking(o, len(uf))
                eb += sinfo["n_iters"] * (1 if chunking is None else chunking[2])
            if lm_core._cuda_cost_eval(o, torch.float64, objp):
                # + the cost evaluation after a pose repair (mixed options)
                ec += sinfo["nfev"] + int(k == 0 and "n_poses_repaired" in info)
        mixed = solves[0][2] if solves else {}
        check(bool(solves) and int(info["n_iters"]) == mixed["n_iters"]
              and int(info["nfev"]) == mixed["nfev"], "info is not the mixed solve's")
        check((nb, nc) == (eb, ec), f"wrapper calls blocks {nb}, cost {nc}; the solves "
              f"account for {eb}, {ec}")
        pred = mct.predict_calib_uvs(a_ext, a_intr, rig.calib_objpoints, a_poses,
                                     device=dev).cpu().numpy()
        err = np.linalg.norm(rig.all_calib_uvs[:, uf] - pred, axis=-1)
        rmse = float(np.sqrt(np.nanmean(err**2)))
        check(rmse < BA_RMSE_PX, f"RMSE {rmse:.4f} px")
        cost, at_jax = f64_costs(uf, a_ext, a_intr, a_poses)
        check(cost <= at_jax * (1 + BA_COST_RTOL),
              f"f64 cost {cost} above JAX's result's {at_jax} on the same frames")
        return SimpleNamespace(uf=uf, info=info, rmse=rmse, wall=wall, nb=nb, nc=nc,
                               mixed_cost=float(mixed["final_cost"]), start=solves[0][0],
                               opts=solves[0][1], cost=cost, at_jax=at_jax,
                               result=(a_ext, a_intr, a_poses))

    def describe(r):
        extra = ", ".join(f"{k} {int(r.info[k])}" for k in ("polish_iters", "n_poses_repaired")
                          if k in r.info)
        return (f"{len(r.uf)} frames, n_iters {int(r.info['n_iters'])} nfev "
                f"{int(r.info['nfev'])} ({extra}), mixed solve's own final cost "
                f"{r.mixed_cost:.4f}, final cost {float(r.info['final_cost']):.4f} (JAX "
                f"{float(ref['final_cost']):.4f} on its {len(ref['use_frames'])} frames), f64 "
                f"cost {r.cost:.4f} vs {r.at_jax:.4f} at JAX's result on these frames (rel "
                f"{(r.cost - r.at_jax) / r.at_jax:+.2e}), RMSE {r.rmse:.4f} px, block calls "
                f"{r.nb} cost calls {r.nc}")

    def same_as_jax(r, label):
        check(np.array_equal(r.uf, ref["use_frames"]), f"{label}: use_frames differ from JAX's")
        cost, jcost = float(r.info["final_cost"]), float(ref["final_cost"])
        check(cost <= jcost * (1 + BA_COST_RTOL), f"{label}: final cost {cost} above JAX's {jcost}")

    bundle_adjustment.lm_solve = recording_lm_solve
    try:
        port_start = (ext, intr, poses)
        run(port_start)  # warm-up
        # The main path: counts from 0, read just after.
        ba_cuda.ba_chunk_blocks.launches = ba_cuda.ba_chunk_cost.launches = 0
        main = run(port_start)
        check(ba_cuda.ba_chunk_blocks.launches > 0 and ba_cuda.ba_chunk_cost.launches > 0,
              "bundle_adjust did not launch both BA kernels")
        held = hold_kernels_at(torch, main.start, main.opts, errs)
        ratios = selection_ratios(torch, dev, rig, *jax_start)
        differ = sorted(set(main.uf.tolist()) ^ set(ref["use_frames"].tolist()))
        far = [f for f in differ if abs(ratios[f] - 1.0) > SELECT_MARGIN]
        check(not far, f"frames {far} selected differently from JAX, not near its threshold")
        metrics.stage_times.clear()
        timed_main = [run(port_start) for _ in range(5)]
        stages = stage_text(metrics.stage_times, len(timed_main))
        log("11 bundle_adjust", "from phase 10's start, default options: " + describe(main)
            + f"; frames selected unlike JAX: {differ} (worst error / threshold at JAX's start "
            + ", ".join(f"{ratios[f]:.4f}" for f in differ) + "); wall "
            + walls_text([r.wall for r in timed_main]) + f"; stages per call: {stages}; "
            "kernels vs twins at the mixed solve's start, " + held)

        variants = {"kernel": {}, "frame_chunk=256": {"lm_options": {"frame_chunk": CHUNK}},
                    "plain": {"lm_options": {"cost_impl": "torch", "block_impl": "torch"}}}
        runs = {}
        for label, kw in variants.items():
            rs = runs[label] = [run(jax_start, **kw) for _ in range(3 if label == "kernel" else 2)]
            for r in rs:
                same_as_jax(r, label)
            extra = ""
            if label == "kernel":
                check(rs[-1].nb > 0 and rs[-1].nc > 0, "kernels not launched")
                r, prof = profiled(torch, lambda: run(jax_start), "11 bundle_adjust kernel")
                names = [re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                nk = (names.count("ba_blocks_kernel"), names.count("ba_cost_kernel"))
                check(nk == (r.nb, r.nc), f"profiler: kernel launches {nk}, wrapper calls "
                      f"{r.nb}, {r.nc}")
                extra = (f"; under torch.profiler ba_blocks_kernel {nk[0]}, ba_cost_kernel "
                         f"{nk[1]} launches; kernels vs twins at the mixed solve's start, "
                         + hold_kernels_at(torch, rs[-1].start, rs[-1].opts, errs))
            log(f"11 bundle_adjust {label}", "from JAX's start, use_frames as JAX's: "
                + describe(rs[-1]) + "; wall " + walls_text([r.wall for r in rs]) + extra)
        plain = runs["plain"][-1].mixed_cost
        for label in ("kernel", "frame_chunk=256"):
            mixed = runs[label][-1].mixed_cost
            check(abs(mixed - plain) <= BA_COST_RTOL * plain,
                  f"{label}: the mixed solve's own final cost {mixed} vs the plain route's {plain}")
    finally:
        bundle_adjustment.lm_solve = lm_solve
    return main.result


def noisy_batches(d, n, seed):
    """``n`` batches of BATCH: the clean stored frames tiled, with fresh
    seeded +-2 noise per batch (scripts/bench_detection.py:176-188), and
    their ground truth."""
    clean = np.nonzero(d["kind"] == "clean")[0]
    reps = -(-BATCH // len(clean))
    tiled = np.concatenate([d["frames"][clean]] * reps)[:BATCH]
    gt = np.concatenate([d["gt"][clean]] * reps)[:BATCH]
    rng = np.random.default_rng(seed)
    return [np.clip(tiled.astype(np.int16) + rng.integers(-2, 3, tiled.shape, dtype=np.int16),
                    0, 255).astype(np.uint8) for _ in range(n)], gt


def same_as_stored(got, accepted, uvs, scores, what):
    """The JAX package's stored decisions, corners within 0.01 px, sorted
    anchor scores within 1e-3. Returns the largest corner difference."""
    acc = np.nonzero(accepted)[0]
    check(sorted(got) == sorted(int(i) for i in acc),
          f"{what}: accepted frames {sorted(got)} != JAX's {acc.tolist()}")
    du = ds = 0.0
    for j, i in enumerate(acc):
        du = max(du, float(np.abs(np.asarray(got[int(i)][0]) - uvs[j]).max()))
        ds = max(ds, float(np.abs(np.asarray(got[int(i)][1]) - scores[j]).max()))
    check(du <= 0.01, f"{what}: corners differ from JAX's by {du:.4f} px")
    check(ds <= 1e-3, f"{what}: anchor scores differ from JAX's by {ds:.2e}")
    return du


def time_corner(torch, gray, sigma, nms):
    """(kernel ms, twin ms, bound) of the peaks kernel on ``gray``."""
    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    B, H, W = gray.shape
    return (cuda_ms(torch, lambda: cc.corner_response_peaks(gray, sigma, nms)),
            cuda_ms(torch, lambda: cc.corner_response_peaks_reference(gray, sigma, nms), 3),
            corner_bound(B, H, W, sigma, nms, True))


def corner_shape_text(shape, nms, rows):
    return f"{shape} nms {nms}: " + "; ".join(
        f"sigma {sigma} {ms:.4f} ms, twin {tw:.4f} (bound {b[0]:.4f}, {b[1]}; {ms / b[0]:.1f}x)"
        for sigma, (ms, tw, b) in rows.items())


def lowband_phase(torch, dev, errs):
    """Phase 12: the low-band path. Returns {shape: {sigma: (ms, twin ms,
    bound)}} of the corner kernel at its shapes."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.detection import detector
    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    low = np.load(os.path.join(DATA, "detect_lowband.npz"))
    board = tuple(int(v) for v in d["board_shape"])
    batches, gt = noisy_batches(d, TIMED_CALLS + 1, seed=12)
    kernel_times = {}
    for f in LOWBAND_F:
        g = torch.as_tensor(detector._decimate_u8(batches[0], f), device=dev).float() / 255.0
        nms = max(2, int(round(4 / f)))
        msg = []
        for sigma in (1.5, 3.5, 6.0, 9.0):
            errs["corner_peaks_kernel"] = max(errs["corner_peaks_kernel"],
                                              compare_corner(torch, g, sigma, nms, True))
        rows = {sigma: time_corner(torch, g, sigma, nms) for sigma in (1.5, 3.5, 6.0, 9.0)}
        kernel_times[tuple(g.shape)] = rows
        msg.append(corner_shape_text(tuple(g.shape), nms, rows))
        log(f"12 kernel f={f}", "bit-equal to its twin at sigma 1.5, 3.5, 6, 9 (and a "
            "relaunch); " + "; ".join(msg))

    def detect(images, f):
        before = (cc.corner_response_peaks.launches, detector._upload.nbytes)
        out, wall = timed(torch, lambda: mct.detect_chessboard_batch(
            list(images), board_shape=board, coarse_downscale=f, device=dev))
        return (out, wall, cc.corner_response_peaks.launches - before[0],
                detector._upload.nbytes - before[1])

    for f in LOWBAND_F:
        got = detect(d["frames"], f)[0]
        du = same_as_stored(got, low[f"low{f}_accepted"], low[f"low{f}_uvs"],
                            low[f"low{f}_scores"], f"stored frames f={f}")
        log(f"12 parity f={f}", f"{len(d['frames'])} stored frames: accepted "
            f"{len(got)}/{len(d['frames'])} as JAX's low-band run; max |corner diff| {du:.2e} px")

    for f in (1,) + LOWBAND_F:
        detect(batches[0], f)  # warm-up
    res = {f: [] for f in (1,) + LOWBAND_F}
    cc.corner_response_peaks.launches = 0  # the low-band main path, read after the loop
    for r, b in enumerate(batches[1:]):
        order = ((1,) + LOWBAND_F)[r % 3:] + ((1,) + LOWBAND_F)[: r % 3]
        for f in order:
            res[f].append(detect(b, f))
        full = res[1][-1][0]
        for f in LOWBAND_F:
            out = res[f][-1][0]
            check(sorted(out) == sorted(full), f"f={f}: frames {sorted(out)} vs f=1 {sorted(full)}")
            dev_max = max(float(np.abs(out[i][0] - full[i][0]).max()) for i in full)
            check(dev_max < 0.25, f"f={f}: a corner {dev_max:.3f} px from the f=1 path's")
    n_low = sum(n for f in LOWBAND_F for _, _, n, _ in res[f])
    check(n_low > 0, "the low-band path did not launch the corner kernel")
    for f, rs in res.items():
        n_det = sum(len(o) for o, *_ in rs)
        rate = n_det / (BATCH * TIMED_CALLS)
        err = np.concatenate([((o[i][0] - gt[i]) ** 2).sum(-1) for o, *_ in rs for i in o])
        rms = float(np.sqrt(err.mean()))
        check(rate == 1.0, f"f={f}: detection rate {rate}")
        check(rms < 0.6, f"f={f}: RMS corner error {rms:.4f} px")
        fps = [BATCH / w for _, w, _, _ in rs]
        log(f"12 detection f={f}", f"batch {BATCH} x {d['frames'].shape[1]}x{d['frames'].shape[2]}"
            f", interleaved with f=1,2,3: median {statistics.median(fps):.1f} frames/s (runs "
            + ", ".join(f"{v:.1f}" for v in fps) + f"); detection rate {rate:.3f}; RMS corner "
            f"error {rms:.4f} px; image bytes uploaded per call "
            + ", ".join(sorted({str(u) for *_, u in rs})) + "; corner-kernel launches per call "
            + ", ".join(str(n) for _, _, n, _ in rs))
    return kernel_times


def device_overlap(torch, prof):
    """From one profiler pass over ``detect_chessboard_batches``: for each
    batch after the first, (ms of its device work that ran inside the
    previous batch's host half, ms of its device work before its own host
    half began). A batch's stream is the stream of the host-to-device copy
    that starts while it is dispatched; its device work is what runs on that
    stream from its dispatch to its host half. Returns (pairs, note)."""
    evs = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU

    def ranges(name):
        return sorted((e.time_range.start, e.time_range.end) for e in evs
                      if e.name == f"detect_chessboard_batches.{name}" and e.device_type == cpu)

    dispatches, finishes = ranges("dispatch"), ranges("finish")
    dev_evs = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("detect_chessboard_batches")
               and not getattr(e, "is_user_annotation", False)]
    copies = sorted((e for e in dev_evs if "HtoD" in e.name), key=lambda e: e.time_range.start)
    out, missing = [], []
    for k in range(1, min(len(dispatches), len(finishes))):
        ds, de = dispatches[k]
        copy = next((e for e in copies if ds <= e.time_range.start <= de), None)
        if copy is None:
            missing.append(k)
            continue
        stream = copy.device_resource_id
        mine = [e for e in dev_evs if e.device_resource_id == stream
                and ds <= e.time_range.start < finishes[k][0]]
        fs, fe = finishes[k - 1]
        inside = sum(max(0.0, min(e.time_range.end, fe) - max(e.time_range.start, fs))
                     for e in mine)
        out.append((inside / 1e3, sum(e.time_range.elapsed_us() for e in mine) / 1e3))
    note = (f"{len(dispatches)} dispatches, {len(finishes)} host halves, {len(copies)} "
            f"host-to-device copies ({', '.join(sorted({e.name for e in copies}))}); no copy "
            f"found inside the dispatch of batches {missing}" if missing else "")
    return out, note


def streaming_phase(torch, dev):
    """Phase 13: streamed batches against sequential calls."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    board = tuple(int(v) for v in d["board_shape"])
    full, _ = noisy_batches(d, STREAM_BATCHES - 1, seed=13)
    batches = full[:EMPTY_AT] + [[]] + full[EMPTY_AT:]
    n_frames = sum(len(b) for b in batches)

    def streamed(f):
        return list(mct.detect_chessboard_batches(batches, board_shape=board, coarse_downscale=f,
                                                  device=dev))

    def sequential(f):
        return [mct.detect_chessboard_batch(list(b), board_shape=board, coarse_downscale=f,
                                            device=dev) if len(b) else {} for b in batches]

    for f in (1, 2):
        cc.corner_response_peaks.launches = 0  # the streamed main path, read just after
        got = streamed(f)
        check(cc.corner_response_peaks.launches > 0, "streaming did not launch the corner kernel")
        want = sequential(f)
        check(len(got) == len(batches) and got[EMPTY_AT] == {}, f"f={f}: not one dict per batch")
        for k, (g, w) in enumerate(zip(got, want)):
            check(sorted(g) == sorted(w) and all(
                np.array_equal(g[i][0], w[i][0]) and np.array_equal(g[i][1], w[i][1]) for i in w),
                f"f={f}: batch {k} differs from its sequential call")
        walls = {"streamed": [], "sequential": []}
        for name in ("streamed", "sequential", "sequential", "streamed"):
            walls[name].append(timed(torch, lambda: (streamed if name == "streamed"
                                                     else sequential)(f))[1])
        log(f"13 streaming f={f}", f"{len(batches)} batches ({n_frames} frames, batch {EMPTY_AT} "
            f"empty): every dict bit-equal to its sequential call; frames/s streamed "
            + ", ".join(f"{n_frames / w:.1f}" for w in walls["streamed"]) + ", sequential "
            + ", ".join(f"{n_frames / w:.1f}" for w in walls["sequential"])
            + " (interleaved: streamed, sequential, sequential, streamed)")
    # Dispatch must not synchronise: one warm streamed run with every
    # synchronising CUDA call inside a dispatch raising.
    from multicam_calibration_tpu_torch.detection import detector

    dispatch = detector._BatchOptions.dispatch

    def strict_dispatch(self, images, stage=None):
        if stage is None:  # a host half's own calls (the low band's escalation)
            return dispatch(self, images, stage)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, images, stage)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    detector._BatchOptions.dispatch = strict_dispatch
    try:
        for f in (1, 2):
            streamed(f)
    finally:
        detector._BatchOptions.dispatch = dispatch
    log("13 no sync", "f=1 and f=2: no dispatch called a synchronising CUDA operation "
        "(torch.cuda.set_sync_debug_mode('error') inside each dispatch)")
    _, prof = profiled(torch, lambda: streamed(1), "13 overlap")
    ov, note = device_overlap(torch, prof)
    log("13 overlap", "f=1, one profiled streamed run: device ms of batch k+1 run during "
        "batch k's host half / its device ms before its own host half: "
        + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in ov)
        + f"; total {sum(a for a, _ in ov):.2f} of {sum(b for _, b in ov):.2f} ms"
        + (f" (not measured for every batch: {note})" if note else ""))


def scale_phase(torch, dev, errs):
    """Phase 14: the single-frame scale_factor path. Returns {shape: {sigma:
    (ms, twin ms, bound)}} of the corner kernel at its shapes."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.detection import detector
    from multicam_calibration_tpu_torch.ops import corner_cuda as cc

    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    low = np.load(os.path.join(DATA, "detect_lowband.npz"))
    board = tuple(int(v) for v in d["board_shape"])
    frames = d["frames"]
    gray = detector._to_gray_f(frames[int(low["resize_frame"])], dev)
    ref = low["resize_gray"]
    got = detector._resize_bilinear(gray, ref.shape).cpu().numpy()
    rerr = float(np.abs(got - ref).max())
    check(rerr <= 1e-4, f"resize differs from jax.image.resize by {rerr:.2e}")
    kernel_times = {}
    for s in SCALES:
        g = detector._resize_bilinear(gray, (int(round(480 * s)), int(round(640 * s))))[None] / 255.0
        errs["corner_peaks_kernel"] = max(errs["corner_peaks_kernel"],
                                          compare_corner(torch, g, 1.5, 4, True))
        kernel_times[tuple(g.shape)] = {1.5: time_corner(torch, g, 1.5, 4)}
    log("14 kernel", "bit-equal to its twin; " + "; ".join(
        corner_shape_text(shape, 4, rows) for shape, rows in kernel_times.items()))
    for s in SCALES:
        key = f"scale{int(round(100 * s)):03d}"
        cc.corner_response_peaks.launches = 0  # the scale_factor main path, read just after
        walls, out = [], {}
        for i, fr in enumerate(frames):
            r, w = timed(torch, lambda: mct.detect_chessboard(fr, board_shape=board, scale_factor=s,
                                                              device=dev))
            walls.append(w)
            if r is not None:
                out[i] = r
        n = cc.corner_response_peaks.launches
        check(n >= len(frames), f"scale {s}: {n} corner-kernel launches for {len(frames)} frames")
        du = same_as_stored(out, low[f"{key}_accepted"], low[f"{key}_uvs"], low[f"{key}_scores"],
                            f"scale_factor {s}")
        log(f"14 scale_factor {s}", f"{len(frames)} stored frames: accepted {len(out)} as JAX's; "
            f"max |corner diff| {du:.2e} px; resize max |diff| {rerr:.2e}; median "
            f"{1e3 * statistics.median(walls):.2f} ms per frame; corner-kernel launches {n}")
    return kernel_times


def lattice_up_to_symmetry(ga, gb):
    """True when two grown lattices ({(i, j): candidate}) select the same
    candidate at every cell under one of the 8 flip/transpose symmetries and
    a translation."""
    if ga is None or gb is None:
        return ga is gb
    cell_of = {v: k for k, v in gb.items()}
    if len(ga) != len(gb) or len(cell_of) != len(gb) or set(cell_of) != set(ga.values()):
        return False
    for swap in (False, True):
        for si in (1, -1):
            for sj in (1, -1):
                offs = {(cell_of[v][0] - si * (j if swap else i),
                         cell_of[v][1] - sj * (i if swap else j)) for (i, j), v in ga.items()}
                if len(offs) == 1:
                    return True
    return False


def lattice_phase(torch, dev, lattice_build):
    """Phase 15: the native lattice growth against the numpy route."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.detection import detector, native_lattice

    built = lattice_build.result()
    log("15 build", f"{built.path.name} in {built.build_s:.2f} s; log: "
        + " | ".join(ln.strip() for ln in built.log.splitlines() if ln.strip()))
    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    board = tuple(int(v) for v in d["board_shape"])
    n_needed = board[0] * board[1]
    n_grids = 0
    for k, (p, s) in enumerate(zip(d["cand_xy"].astype(float), d["cand_score"].astype(float))):
        rn = native_lattice.grow_lattice(p, s, n_needed, 0.35)
        rp = detector._grow_lattice_numpy(p, s, n_needed, 0.35)
        check(np.array_equal(rn[0], rp[0]) and abs(rn[2] - rp[2]) <= 1e-9,
              f"frame {k}: native growth keeps other candidates or pitch than numpy")
        check((rn[3] is None) == (rp[3] is None) and (rn[3] is None or (
            set(rn[3].values()) == set(rp[3].values()) and lattice_up_to_symmetry(rn[3], rp[3]))),
            f"frame {k}: native lattice differs from numpy's beyond symmetry")
        n_grids += rn[3] is not None

    def numpy_route(on):
        if on:
            os.environ[native_lattice.DISABLE_ENV] = "1"
        else:
            os.environ.pop(native_lattice.DISABLE_ENV, None)

    grow = native_lattice.grow_lattice

    def counted(*args):
        counted.calls += 1
        return grow(*args)

    sets = {"hard": d["kind"] == "hard", "blurred": np.char.startswith(d["kind"], "blur")}
    finish_ms, dets = {}, {}
    native_lattice.grow_lattice = counted
    try:
        for name, pick in sets.items():
            stage1 = detector._batch_dispatch(list(d["frames"][pick]), 160, 4, 5, board, 40, dev)
            ms = finish_ms[name] = {"native": [], "numpy": [], "native calls": 0}
            for route in ("native", "numpy") * 5:
                numpy_route(route == "numpy")
                counted.calls = 0
                ms[route].append(1e3 * timed(torch, lambda: detector._batch_finish(
                    stage1, int(pick.sum()), board, True, 0.2, 40))[1])
                if route == "native":
                    ms["native calls"] = counted.calls
        for route in ("native", "numpy"):
            numpy_route(route == "numpy")
            dets[route] = mct.detect_chessboard_batch(list(d["frames"]), board_shape=board,
                                                      device=dev)
    finally:
        numpy_route(False)
        native_lattice.grow_lattice = grow
    a, b = dets["native"], dets["numpy"]
    du = max((float(np.abs(a[i][0] - b[i][0]).max()) for i in a), default=0.0)
    check(sorted(a) == sorted(b) and du <= 1e-5,
          f"detections differ between the routes: {sorted(a)} vs {sorted(b)}, {du:.2e} px")
    log("15 native lattice", f"stored candidates of {len(d['frames'])} frames: {n_grids} grids, "
        "native = numpy (same candidates, pitch, corner set; lattice up to symmetry); "
        + "; ".join(
            f"host half on the {int(sets[name].sum())} stored {name} frames ({ms['native calls']} "
            f"native growth calls), ms: native " + ", ".join(f"{v:.2f}" for v in ms["native"])
            + f" (median {statistics.median(ms['native']):.2f}), numpy "
            + ", ".join(f"{v:.2f}" for v in ms["numpy"])
            + f" (median {statistics.median(ms['numpy']):.2f})"
            for name, ms in finish_ms.items())
        + f"; detect_chessboard_batch on the stored frames: {len(a)} accepted on either route, "
        f"max |corner diff| {du:.1e} px")


def close_to(got, want, rtol, atol, what):
    """Elementwise |got - want| <= atol + rtol |want| with NaN where ``want``
    is NaN; returns the largest |got - want| / (atol + rtol |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    check(np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN where JAX has none")
    ok = ~np.isnan(want)
    diff, tol = np.abs(got[ok] - want[ok]), atol + rtol * np.abs(want[ok])
    ratio = np.where(tol > 0, diff / np.where(tol > 0, tol, 1.0), np.where(diff > 0, np.inf, 0.0))
    worst = float(ratio.max(initial=0.0))
    check(worst <= 1.0, f"{what}: off JAX's by {worst:.3e} x its tolerance "
          f"(rtol {rtol:g}, atol {atol:g})")
    return worst


def uncertainty_phase(torch, dev, ref):
    """Phase 16: calibration_uncertainty at JAX's adjusted bench result, f64
    on the card, against JAX's answer. Returns the bench rig."""
    import multicam_calibration_tpu_torch as mct

    bench = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
    rig = mct.make_synthetic_rig(**RIG)
    uf = bench["use_frames"]
    args = (rig.all_calib_uvs[:, uf], bench["adj_ext"],
            list(zip(bench["adj_K"], bench["adj_dist"])), rig.calib_objpoints,
            bench["adj_poses"])
    out, warm = timed(torch, lambda: mct.calibration_uncertainty(*args, device=dev))
    walls = [timed(torch, lambda: mct.calibration_uncertainty(*args, device=dev))[1]
             for _ in range(3)]
    w_cam = close_to(out["camera_sd"], ref["unc_camera_sd"], UNC_RTOL, 0.0, "camera_sd")
    w_pose = close_to(out["pose_sd"], ref["unc_pose_sd"], UNC_RTOL, 0.0, "pose_sd")
    check(out["dof"] == float(ref["unc_dof"]), f"dof {out['dof']} != JAX's {ref['unc_dof']}")
    check(np.all(out["camera_sd"][0, 6:] == 0.0), "the root camera's extrinsic sd is not 0")
    log("16 uncertainty", f"{rig.n_cameras} x {len(uf)} x {rig.calib_objpoints.shape[0]} at "
        f"JAX's adjusted bench result, f64: camera_sd, pose_sd within {UNC_RTOL:g} relative of "
        f"JAX's (worst err/tol {w_cam:.2e}, {w_pose:.2e}), dof {out['dof']:.0f} as JAX, "
        f"sigma {out['sigma_px']:.6f} px (JAX {float(ref['unc_sigma_px']):.6f}), root "
        f"extrinsic sd 0; wall " + walls_text(walls) + f", warm-up {warm:.4f} s")
    return rig


def big_triangulation_views(torch, dev, rig):
    """TRI_BIG points on the card: the rig's board points at its poses,
    jittered by 10 mm, projected by its true cameras with 0.3 px noise;
    ``missing`` of the views NaN, ``corrupt`` moved by up to 300 px.
    Returns (per-camera (n, 2) tensors, the true points)."""
    from multicam_calibration_tpu_torch.models.bundle_adjustment import embed_calib_objpoints
    from multicam_calibration_tpu_torch.ops import project_points

    p = TRI_BIG
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    n = p["n_points"]
    board = embed_calib_objpoints(rig.calib_objpoints, rig.calib_poses, device=dev).reshape(-1, 3)
    pick = torch.randint(0, board.shape[0], (n,), generator=gen, device=dev)
    truth = board[pick] + 10.0 * torch.randn((n, 3), generator=gen, device=dev,
                                             dtype=torch.float64)
    views = []
    for ext, (K, d) in zip(rig.all_extrinsics, rig.all_intrinsics):
        uv = project_points(truth, torch.as_tensor(ext, device=dev), K, d)
        uv = uv + NOISE_PX * torch.randn(uv.shape, generator=gen, device=dev, dtype=uv.dtype)
        u = torch.rand((n,), generator=gen, device=dev)
        bad = u < p["corrupt"]
        uv = torch.where(bad[:, None], uv + 300.0 * (2 * torch.rand(uv.shape, generator=gen,
                         device=dev, dtype=uv.dtype) - 1), uv)
        views.append(torch.where((u > 1 - p["missing"])[:, None], torch.nan, uv))
    return views, truth


def triangulation_phase(torch, dev, rig, ref, port_ba):
    """Phase 17: triangulate against JAX on the bench rig's corners, its
    accuracy from the port's phase 11 result, and a timed call at TRI_BIG."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.synthetic import _t6_to_T

    bench = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
    views, truth = triangulation_views(rig, TRI_FRAMES)
    jax_cams = (list(bench["adj_ext"]), list(zip(bench["adj_K"], bench["adj_dist"])))
    med = mct.triangulate(views, *jax_cams, refine=False, device=dev)
    (pts, sd), wall = timed(torch, lambda: mct.triangulate(views, *jax_cams, return_sd=True,
                                                          device=dev))
    worst = [close_to(x.cpu().numpy(), ref[k], TRI_RTOL, TRI_ATOL_MM, k) for x, k in
             ((med, "tri_median"), (pts, "tri_points"), (sd, "tri_sd"))]

    def median_error(ext, intr):
        """Median distance of the refined points to the true ones, both in
        camera 0's frame (the calibration's gauge is its own)."""
        got = mct.triangulate(views, list(ext), intr, device=dev).cpu().numpy()
        T_est, T_true = _t6_to_T(np.asarray(ext)[0]), _t6_to_T(rig.all_extrinsics[0])
        a = got @ T_est[:3, :3].T + T_est[:3, 3]
        b = truth @ T_true[:3, :3].T + T_true[:3, 3]
        err = np.linalg.norm(a - b, axis=-1)
        return float(np.nanmedian(err)), int(np.isfinite(err).sum())

    port_err, n_port = median_error(port_ba[0], port_ba[1])
    check(port_err < 1.0, f"median error {port_err:.4f} mm to the true board points")
    jax_err, _ = median_error(*jax_cams)

    big, big_truth = big_triangulation_views(torch, dev, rig)
    cams = (list(rig.all_extrinsics), rig.all_intrinsics)
    mct.triangulate(big, *cams, return_sd=True, device=dev)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    (bp, bsd), big_wall = timed(torch, lambda: mct.triangulate(big, *cams, return_sd=True,
                                                              device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    med_wall = timed(torch, lambda: mct.triangulate(big, *cams, refine=False, device=dev))[1]
    berr = torch.linalg.vector_norm(bp - big_truth, dim=-1)
    ok = torch.isfinite(berr)
    big_err = float(berr[ok].median())
    n_sd = int(torch.isfinite(bsd).all(-1).sum())
    check(big_err < 1.0, f"TRI_BIG: median error {big_err:.4f} mm")
    log("17 triangulation", f"{len(views)} cameras x {len(truth)} corners ({TRI_FRAMES} bench "
        f"frames) at JAX's adjusted cameras: median (refine=False), points and sd within "
        f"{TRI_RTOL:g} relative + {TRI_ATOL_MM:g} mm of JAX's (worst err/tol "
        + ", ".join(f"{w:.2e}" for w in worst) + f"), wall {wall:.4f} s; median error to the "
        f"true corners {port_err:.4f} mm from phase 11's result ({n_port} points; {jax_err:.4f} "
        f"at JAX's); {len(big)} x {TRI_BIG['n_points']} points ({TRI_BIG['missing']:.0%} of "
        f"views missing, {TRI_BIG['corrupt']:.0%} corrupted): refine + sd wall {big_wall:.4f} s, "
        f"median only {med_wall:.4f} s, peak device memory {peak / 2**30:.3f} GiB, "
        f"{int(ok.sum())} points finite ({n_sd} with an sd), median error {big_err:.4f} mm")


def flatibration_phase(torch, dev, ref):
    """Phase 18: flatibration against JAX (its samples fed in), the port's
    own draw, and a timed fit of FLOOR_BIG points."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.models import flatibration

    pts, _ = floor_points(**FLOOR)
    a, b, t, mask = flatibration._ransac_plane_fit_from_samples(
        torch.as_tensor(pts, device=dev), torch.as_tensor(ref["floor_idx"], device=dev), 10.0)
    check(np.array_equal(mask.cpu().numpy(), ref["floor_mask"]), "inlier mask differs from JAX's")
    w_plane = close_to(torch.stack([a, b, t]).cpu().numpy(), ref["floor_plane"], 0.0,
                       PLANE_ATOL, "plane")
    transform = mct.flatibrate(pts, device=dev)
    worst = [close_to(got, ref[k], 0.0, FLAT_ATOL, k) for got, k in (
        (transform, "floor_transform"),
        (mct.flip_z_axis(ref["floor_transform"], device=dev), "floor_flip"),
        (mct.center_arena(ref["floor_transform"], pts, device=dev), "floor_center"))]
    own = flatibration.ransac_plane_fit(pts, device=dev)[3].cpu().numpy()
    check(np.array_equal(own, ref["floor_mask"]), "the port's own draw: inliers differ")

    big, out = floor_points(FLOOR_BIG, FLOOR["seed"])
    call = lambda: mct.flatibrate(big, n_hypotheses=FLOOR_HYP, device=dev)  # noqa: E731
    tr, warm = timed(torch, call)
    walls = [timed(torch, call)[1] for _ in range(5)]
    flat = mct.apply_rigid_transform(torch.as_tensor(tr), torch.as_tensor(big)).numpy()
    inl = np.setdiff1d(np.arange(FLOOR_BIG), out)
    z = float(np.median(np.abs(flat[inl, 2])))
    check(z < 1.0, f"flattened floor: median |z| {z:.4f} mm")
    log("18 flatibration", f"{FLOOR['n']} points with JAX's samples: inlier mask as JAX "
        f"({int(ref['floor_mask'].sum())}), plane within {PLANE_ATOL:g} (err/tol {w_plane:.2e}); "
        f"flatibrate, flip_z_axis, center_arena within {FLAT_ATOL:g} (err/tol "
        + ", ".join(f"{w:.2e}" for w in worst) + "); the port's own draw: the same inliers; "
        f"{FLOOR_BIG} points x {FLOOR_HYP} hypotheses: wall " + walls_text(walls)
        + f", warm-up {warm:.4f} s, median |z| of the flattened inliers {z:.4f} mm")


def rolling_phase(torch, dev, ref, errs):
    """Phase 19: RollingCalibrator, the f64 check against JAX and BASELINE
    config 4 at bench_streaming.py's shape through both BA kernels."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.models import lm_core, streaming
    from multicam_calibration_tpu_torch.ops import ba_cuda

    solves = []  # (start arrays, options, info) of every lm_solve of an update
    lm_solve = streaming.lm_solve

    def recording_lm_solve(*args, **kwargs):
        out = lm_solve(*args, **kwargs)
        solves.append((args[:5], args[5], out[2]))
        return out

    streaming.lm_solve = recording_lm_solve
    try:
        # The f64 check: JAX's options carried over, per-update state as JAX's.
        p = STREAM_F64
        rig = mct.make_synthetic_rig(n_cameras=p["n_cameras"], n_frames=p["n_frames"],
                                     noise_px=NOISE_PX, dropout=0.25, seed=p["seed"])
        ext, intr = stream_start(rig, p["seed"])
        opts = lm_options_from_jax(json.loads(str(ref["stream_options"])))
        rc = mct.RollingCalibrator(ext, intr, rig.calib_objpoints, window=p["window"],
                                   protect_recent=p["protect"], lm_options=opts, device=dev)
        before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
        worst = [0.0, 0.0]
        for k, lo in enumerate(range(0, p["n_frames"], p["batch"])):
            info = rc.update(rig.all_calib_uvs[:, lo:lo + p["batch"]])
            for key in ("n_iters", "admitted", "occupancy"):
                check(info[key] == int(ref[f"stream_{key}"][k]),
                      f"f64 update {k}: {key} {info[key]} != JAX's {ref[f'stream_{key}'][k]}")
            check(np.array_equal(rc._order, ref["stream_order"][k]),
                  f"f64 update {k}: window slots differ from JAX's")
            worst[0] = max(worst[0], close_to(info["cost"], ref["stream_cost"][k],
                                              STREAM_RTOL, 0.0, f"f64 update {k}: cost"))
            worst[1] = max(worst[1], close_to(
                relative_extrinsics(rc.calibration()[0]),
                relative_extrinsics(ref["stream_ext"][k]), STREAM_RTOL, STREAM_RTOL,
                f"f64 update {k}: relative extrinsics"))
        check((ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches) == before,
              "the f64 stream launched a BA kernel")
        log("19 rolling f64", f"{p['n_cameras']} cameras, window {p['window']}, "
            f"{p['n_frames'] // p['batch']} updates of {p['batch']} with JAX's LMOptions "
            f"(plain torch route, no kernel): admitted, occupancy, n_iters and window slots "
            f"as JAX's every update; costs and relative extrinsics within {STREAM_RTOL:g} of "
            f"JAX's (worst err/tol {worst[0]:.2e}, {worst[1]:.2e}); last cost {info['cost']:.6f}")

        # BASELINE config 4 at bench_streaming.py's shape.
        p = STREAM
        rig = mct.make_synthetic_rig(n_cameras=p["n_cameras"],
                                     n_frames=p["window"] + p["batch"] * 16,
                                     noise_px=NOISE_PX, dropout=0.25, seed=p["seed"])
        rc = mct.RollingCalibrator(rig.all_extrinsics, rig.all_intrinsics, rig.calib_objpoints,
                                   window=p["window"], device=dev)
        check(lm_core._cuda_block_build(rc._opts, torch.float64, rc._objp_d)
              and lm_core._cuda_cost_eval(rc._opts, torch.float64, rc._objp_d),
              f"the recipe on CUDA does not reach both kernels: {rc._opts}")
        # Cycled: an update re-run after a lost profiler session may take the
        # rig's first frames again once the others are used.
        batches = itertools.cycle([rig.all_calib_uvs[:, f:f + p["batch"]]
                                   for f in range(0, rig.n_frames, p["batch"])])
        fill_t0 = time.perf_counter()
        n_fill = 0
        while rc.occupancy < p["window"]:
            rc.update(next(batches))
            n_fill += 1
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - fill_t0

        rows = []
        for k in range(p["timed"]):
            solves.clear()
            nb0, nc0 = ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches
            info, wall = timed(torch, lambda: rc.update(next(batches)))
            nb = ba_cuda.ba_chunk_blocks.launches - nb0
            nc = ba_cuda.ba_chunk_cost.launches - nc0
            (start, _, sinfo), = solves
            check(nb == sinfo["n_iters"] == info["n_iters"] and nc == sinfo["nfev"],
                  f"update {k}: block launches {nb}, cost launches {nc}; n_iters "
                  f"{sinfo['n_iters']}, nfev {sinfo['nfev']}")
            rows.append((wall, info, nb, nc, int(start[3].sum())))
            if k == 0:
                held = hold_kernels_at(torch, start, rc._opts, errs)
                cam64, pose64, objp64 = lm_core._kernel_params(start[0], start[1], start[4])
                args = (cam64, pose64, *ba_cuda.ba_prepare_obs(start[2], start[3]), objp64)
                kt = {"ba_blocks_kernel": (ba_cuda.ba_chunk_blocks,
                                           ba_cuda.ba_chunk_blocks_reference),
                      "ba_cost_kernel": (ba_cuda.ba_chunk_cost, ba_cuda.ba_chunk_cost_reference)}
                ktimes = {name: (cuda_ms(torch, lambda f=f: f(*args)),
                                 cuda_ms(torch, lambda r=r: r(*args)),
                                 profile_calls(torch, lambda f=f: f(*args))[1])
                          for name, (f, r) in kt.items()}
                kbounds = ba_bounds(p["n_cameras"], p["window"], rig.calib_objpoints.shape[0],
                                    int(start[3].sum()))
        walls = [r[0] for r in rows]
        cost, n_obs = rows[-1][1]["cost"], rows[-1][4]
        floor_cost = 2 * n_obs * 0.5 * NOISE_PX**2 * (1 - 0.75 * NOISE_PX**2)
        check(cost <= 1.05 * floor_cost, f"final cost {cost:.1f} above 1.05 x the noise floor "
              f"{floor_cost:.1f} of its {n_obs} effective observations")
        rel_est = relative_extrinsics(rc.calibration()[0])
        rel_true = relative_extrinsics(rig.all_extrinsics)
        rot = float(np.abs(rel_est[:, :3] - rel_true[:, :3]).max())
        trans = float(np.linalg.norm(rel_est[:, 3:] - rel_true[:, 3:], axis=-1).max())
        check(rot <= STREAM_ROT_RAD, f"relative rotations off the truth by {rot:.4f} rad")

        prof_counts, splits = [], []

        def profiled_update():
            solves.clear()
            return timed(torch, lambda: rc.update(next(batches)))

        for _ in range(STREAM_PROFILED):
            (_, pwall), prof = profiled(torch, profiled_update, "19 rolling update")
            events = prof.events()
            dev_ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            names = [re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name) for e in dev_ev]
            dev_ev = [e for e in dev_ev if not is_annotation(e)]
            (_, _, sinfo), = solves
            nk = (names.count("ba_blocks_kernel"), names.count("ba_cost_kernel"))
            check(nk == (sinfo["n_iters"], sinfo["nfev"]), f"profiler: kernel launches {nk}, "
                  f"n_iters {sinfo['n_iters']}, nfev {sinfo['nfev']}")
            prof_counts.append(f"{nk[0]}/{nk[1]} of {len(dev_ev)} device ops")
            ranges = {}
            for e in events:
                if e.name.startswith("rolling.") and e.device_type != torch.autograd.DeviceType.CUDA:
                    ranges[e.name] = ranges.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
            top = sorted(((a.key, a.self_cpu_time_total / 1e3) for a in prof.key_averages()
                          if a.key.startswith("aten::")), key=lambda kv: -kv[1])[:6]
            splits.append(f"wall {1e3 * pwall:.1f} ms: " + ", ".join(
                f"{k.removeprefix('rolling.')} {v:.1f}" for k, v in ranges.items())
                + f"; device busy {busy:.2f} ms ({busy / (1e3 * pwall):.1%}); top host ops (self) "
                + ", ".join(f"{k} {v:.1f}" for k, v in top))
    finally:
        streaming.lm_solve = lm_solve

    # calibration_uncertainty at this window (64 cameras: S is 768 x 768).
    mask = solves[-1][0][3].cpu().numpy()
    uvs = np.where(mask[..., None], rc._obs_d.cpu().numpy(), np.nan)
    ext, intr = rc.calibration()
    ucall = lambda: mct.calibration_uncertainty(  # noqa: E731
        uvs, ext, intr, rig.calib_objpoints, rc._poses_d.cpu().numpy(), device=dev)
    unc, uwarm = timed(torch, ucall)
    uwalls = [timed(torch, ucall)[1] for _ in range(3)]
    check(np.all(unc["camera_sd"][0, 6:] == 0.0) and np.all(np.isfinite(unc["camera_sd"])),
          "window uncertainty: root sd not 0 or non-finite sd")

    log("19 rolling", f"{p['n_cameras']} cameras, window {p['window']}, batches of "
        f"{p['batch']} (BASELINE.json config 4, scripts/bench_streaming.py:16-19), f32 recipe: "
        f"fill {n_fill} updates in {fill_s:.3f} s; {p['timed']} timed updates: median "
        + walls_text(walls).removeprefix("median ") + "; per update n_iters/nfev = block/cost "
        "launches " + ", ".join(f"{r[1]['n_iters']}/{r[2]}/{r[3]}" for r in rows)
        + f"; costs " + ", ".join(f"{r[1]['cost']:.1f}" for r in rows)
        + f"; final cost {cost:.1f} <= 1.05 x noise floor {floor_cost:.1f} over {n_obs} "
        f"effective observations (ratio {cost / floor_cost:.4f}); relative extrinsics vs truth: "
        f"rotation max {rot:.2e} rad, translation max {trans:.4f} mm; profiler "
        "ba_blocks/ba_cost launches = n_iters/nfev on " + ", ".join(prof_counts)
        + "; profiled updates (ms): " + " | ".join(splits))
    log("19 kernels", f"at the window's first timed update, C={p['n_cameras']} F={p['window']} "
        f"N={rig.calib_objpoints.shape[0]}: " + held + "; ms per call wrapper vs twin, kernels "
        "alone (profiler), bound: " + "; ".join(
            f"{k} {a:.4f} vs {b:.4f}, alone {1e3 * dev_ms:.2f} us, bound {kbounds[k][0]:.5f} "
            f"ms ({kbounds[k][1]})" for k, (a, b, dev_ms) in ktimes.items()))
    log("16 uncertainty window", f"phase 19's window ({p['n_cameras']} cameras x {p['window']} "
        f"frames, S {12 * p['n_cameras']} x {12 * p['n_cameras']}), f64: wall "
        + walls_text(uwalls) + f", warm-up {uwarm:.4f} s, sigma {unc['sigma_px']:.4f} px")


def host_packages():
    """Which host packages the modules not ported yet would need are here:
    h5py, yaml, pandas and cv2 by import, libavformat by its library."""
    import ctypes
    import ctypes.util
    import importlib

    have = []
    for name in ("h5py", "yaml", "pandas", "cv2"):
        try:
            mod = importlib.import_module(name)
            have.append(f"{name} {getattr(mod, '__version__', '?')}")
        except ImportError:
            have.append(f"{name} absent")
    lib = ctypes.util.find_library("avformat")
    if lib is None:
        have.append("libavformat absent")
    else:
        try:
            v = ctypes.CDLL(lib).avformat_version()
            have.append(f"{lib} {v >> 16}.{(v >> 8) & 255}.{v & 255}")
        except (OSError, AttributeError) as e:
            have.append(f"{lib} found, not loadable ({e})")
    return "; ".join(have)


def main():
    # Keep CUPTI attached between torch.profiler sessions: its teardown after
    # each session and re-init at the next is fragile (torch turns it off
    # itself for CUDA graphs, torch/profiler/profiler.py), and this script
    # opens many sessions in one process.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.ops import _build, ba_cuda

    dev = cuda_device()
    pool = concurrent.futures.ThreadPoolExecutor(3)
    builds = {name: pool.submit(_build.load_library, name)
              for name in ("ba_kernels", "corner_kernels")}
    builds["lattice"] = pool.submit(_build.load_host_library, "lattice")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    log("1 device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build (both sources at once; the corner build is reported in phase 6)
    ba_build = builds["ba_kernels"].result()
    log("2 build", describe_build(ba_build))
    for kernel in ("ba_blocks_kernel", "ba_cost_kernel"):
        ptxas = ptxas_of(ba_build.log, kernel)
        check(ptxas["spill_stores"] == ptxas["spill_loads"] == 0, f"{kernel} spills: {ptxas}")
        log("2 ptxas", f"{kernel}: " + ", ".join(f"{k} {v}" for k, v in ptxas.items()))

    # 3. kernels vs twins on the card
    cam0, poses0, obs, mask, objp = bench_problem(torch, dev)
    prepared = ba_cuda.ba_prepare_obs(obs, mask)
    C, F, N = mask.shape
    # Ragged: F % 4 != 0, zero-pose padded frames with empty masks, and a
    # near-identity gauge-root camera (bench-style +3e-5 shift).
    Fr, pad = 61, 6
    rag_obs = torch.cat([obs[:, :Fr], obs.new_zeros(C, pad, N, 2)], 1)
    rag_mask = torch.cat([mask[:, :Fr], mask.new_zeros(C, pad, N)], 1)
    rag = (cam0 + 3e-5, torch.cat([poses0[:Fr], poses0.new_zeros(pad, 6)]),
           *ba_cuda.ba_prepare_obs(rag_obs, rag_mask), objp)
    bench = (cam0, poses0, *prepared, objp)
    errs = {"ba_blocks_kernel": 0.0, "ba_cost_kernel": 0.0}
    for label, args in (("bench", bench), ("ragged", rag)):
        got = ba_cuda.ba_chunk_blocks(*args)
        ref = ba_cuda.ba_chunk_blocks_reference(*args)
        err, scaled = compare_blocks(got, ref)
        errs["ba_blocks_kernel"] = max(errs["ba_blocks_kernel"], err)
        cerr, trel = compare_cost(ba_cuda.ba_chunk_cost(*args),
                                  ba_cuda.ba_chunk_cost_reference(*args),
                                  ba_cuda.ba_chunk_cost(*args))
        errs["ba_cost_kernel"] = max(errs["ba_cost_kernel"], cerr)
        if label == "ragged":
            check(float(got[1][Fr:].abs().max()) == 0.0, "padded frames leak into V")
        log(f"3 parity {label}", f"C={args[0].shape[0]} F={args[1].shape[0]} N={N} "
            f"blocks max|err| {err:.3e} (err/tol "
            + ", ".join(f"{k} {v:.2e}" for k, v in scaled.items())
            + f"); cost fragments max|err| {cerr:.3e}, total vs f64 sum of fragments rel "
            f"{trel:.1e}, relaunch bit-identical")
    times = {
        "ba_blocks_kernel": (cuda_ms(torch, lambda: ba_cuda.ba_chunk_blocks(*bench)),
                             cuda_ms(torch, lambda: ba_cuda.ba_chunk_blocks_reference(*bench))),
        "ba_cost_kernel": (cuda_ms(torch, lambda: ba_cuda.ba_chunk_cost(*bench)),
                           cuda_ms(torch, lambda: ba_cuda.ba_chunk_cost_reference(*bench))),
    }
    log("3 timing", "bench shape, ms per call, wrapper vs twin: " + "; ".join(
        f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in times.items()))
    prof = {"ba_blocks_kernel": profile_calls(torch, lambda: ba_cuda.ba_chunk_blocks(*bench)),
            "ba_cost_kernel": profile_calls(torch, lambda: ba_cuda.ba_chunk_cost(*bench))}
    check(prof["ba_blocks_kernel"][0] <= 2,
          f"ba_chunk_blocks: {prof['ba_blocks_kernel'][0]} CUDA launches per call")
    check(prof["ba_cost_kernel"][0] <= 2,
          f"ba_chunk_cost: {prof['ba_cost_kernel'][0]} CUDA launches per call")
    log("3 profile", "bench shape, torch.profiler over 10 calls: " + "; ".join(
        f"{k}: {n:g} CUDA launches per call, kernels alone {1e3 * ms:.2f} us per call ("
        + ", ".join(f"{name} {us:.2f}" for name, us in per.items()) + ")"
        for k, (n, ms, per) in prof.items()))
    bounds = ba_bounds(C, F, N, int(mask.sum()))

    # 4. a small solve through the kernels against the plain path
    opts = lm_options_from_jax(BENCH_JAX_OPTIONS)
    check(opts.block_impl == "auto" and opts.cost_impl == "auto", f"options {opts}")
    check(lm_core._cuda_block_build(opts, torch.float64, objp),
          "auto dispatch does not reach the block kernel")
    check(lm_core._cuda_cost_eval(opts, torch.float64, objp),
          "auto dispatch does not reach the cost kernel")
    plain = dataclasses.replace(opts, block_impl="torch", cost_impl="torch")
    rng = np.random.default_rng(0)
    cam_s = cam0 + torch.as_tensor(rng.normal(0, 1e-4, cam0.shape), device=dev)
    args_s = (cam_s, poses0[:48], obs[:, :48], mask[:, :48], objp)
    small_opts = dataclasses.replace(opts, max_iters=40)
    _, _, info_k = lm_core.lm_solve(*args_s, dataclasses.replace(
        small_opts, block_impl="cuda", cost_impl="cuda"))
    _, _, info_p = lm_core.lm_solve(*args_s, dataclasses.replace(plain, max_iters=40))
    ck, cp = info_k["final_cost"], info_p["final_cost"]
    check(abs(ck - cp) <= 1e-3 * cp, f"small solve: kernel {ck} vs plain {cp}")
    log("4 small solve", f"C={C} F=48: kernel path cost {ck:.6f} ({info_k['n_iters']} iters) "
        f"vs plain {cp:.6f} ({info_p['n_iters']} iters)")

    # 5. the bench problem, the main path
    def solve(o, cam):
        before = (ba_cuda.ba_chunk_blocks.launches, ba_cuda.ba_chunk_cost.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, p, info = lm_core.lm_solve(cam, poses0, obs, mask, objp, o)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        blocks = ba_cuda.ba_chunk_blocks.launches - before[0]
        costs = ba_cuda.ba_chunk_cost.launches - before[1]
        return c, p, info, wall, blocks, costs

    def quality(c, p, info):
        """The bench's gate on the solver's own final cost and on the cost of
        its result by the torch route (bench.py's f32 projection)."""
        final = float(lm_core.compute_cost(c, p, obs, mask, objp, plain))
        r = lm_core.compute_residuals(c, p, obs, mask, objp)
        rmse = float(torch.sqrt((r**2).sum() / mask.sum()))  # per point, as bench.py
        for what, v in (("final cost", final), ("the solver's final cost", info["final_cost"])):
            check(np.isfinite(v) and v <= SCIPY_TRF_COST,
                  f"{what} {v} above scipy TRF's {SCIPY_TRF_COST}")
        return final, rmse

    # name -> (options, block launches per iteration, cost launches per evaluation)
    variants = {
        "kernel": (opts, 1, 1),
        "kernel_blocks_only": (dataclasses.replace(opts, cost_impl="torch"), 1, 0),
        "plain": (plain, 0, 0),
    }
    ba_cuda.ba_chunk_blocks.launches = 0
    ba_cuda.ba_chunk_cost.launches = 0
    for o, _, _ in variants.values():  # warm-up
        solve(o, cam0)
    runs = {name: [] for name in variants}
    names = list(variants)
    for k in range(3):
        cam_k = cam0 + 1e-5 * (k + 1)  # as bench.py's timed runs
        for which in names[k:] + names[:k]:  # each variant takes each place once
            o, per_iter, per_eval = variants[which]
            c, p, info, wall, nb, nc = solve(o, cam_k)
            final, rmse = quality(c, p, info)
            check(nb == per_iter * info["n_iters"],
                  f"{which}: block launches {nb}, n_iters {info['n_iters']}")
            check(nc == per_eval * info["nfev"],
                  f"{which}: cost launches {nc}, nfev {info['nfev']}")
            runs[which].append((wall, info["n_iters"], info["nfev"], final, rmse, nb, nc))
    launches = {"ba_blocks_kernel": ba_cuda.ba_chunk_blocks.launches,
                "ba_cost_kernel": ba_cuda.ba_chunk_cost.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the main path")

    def summary(rs):
        walls = [r[0] for r in rs]
        med = sorted(range(len(rs)), key=lambda i: walls[i])[len(rs) // 2]
        wall, it, nfev, final, rmse, nb, nc = rs[med]
        return (f"median wall_s {statistics.median(walls):.4f} (runs "
                + ", ".join(f"{w:.4f}" for w in walls)
                + f") n_iters {it} nfev {nfev} final_cost {final:.4f} rmse_px {rmse:.4f}"
                + f" block_launches {nb} cost_launches {nc}")

    log("5 bench kernel", f"C={C} F={F} N={N} default options, block_impl=auto(cuda) "
        "cost_impl=auto(cuda): " + summary(runs["kernel"]))
    log("5 bench kernel_blocks_only", "block_impl=auto(cuda) cost_impl=torch: "
        + summary(runs["kernel_blocks_only"]))
    log("5 bench plain", "block_impl=torch cost_impl=torch: " + summary(runs["plain"]))

    detect_phases(torch, dev, builds["corner_kernels"], launches, errs, times, bounds)
    cal = calibrate_phase(torch, dev)
    port_ba = bundle_adjust_phase(torch, dev, cal, errs)
    lowband_phase(torch, dev, errs)
    streaming_phase(torch, dev)
    scale_phase(torch, dev, errs)
    lattice_phase(torch, dev, builds["lattice"])
    analysis = np.load(os.path.join(DATA, "analysis_ref.npz"))
    bench_rig = uncertainty_phase(torch, dev, analysis)
    triangulation_phase(torch, dev, bench_rig, analysis, port_ba)
    flatibration_phase(torch, dev, analysis)
    rolling_phase(torch, dev, analysis, errs)
    log("host packages", host_packages())

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, replaces) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
