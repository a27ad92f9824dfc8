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
   frame; the bench problem's cost at the port's start within 1e-6 of the
   cost at JAX's over the frames no moved camera nor unstable pose reaches;
   wall median of 5 calls after a warm-up, with each stage's share. Then
   the same ``calibrate`` once more with its intrinsics solved camera by
   camera (``get_intrinsics``, the route JAX's start was made on) and held
   to every gate above and to the cost over all frames within 1.5e-3; the
   batched route's cost over all frames is printed beside it;
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
   within 0.02 rad of the truth; ``pose_gn_kernel`` launched once an update
   (``pose_gn_kernel.launches`` over the timed updates, and 1 under the
   profiler), and held to its twin on the first timed update's own inputs
   (the homography stage's poses, cameras, detections and mask at 64 x 8
   x 35; ``compare_poses``, the card tests' tolerances), timed (wrapper
   and twin by CUDA events, the kernel alone by the profiler) with its
   bound (``pose_bound``);
20. videos to a saved calibration (``video_phase``): 6 cameras x 600
   frames of 640 x 480 rendered from ``video_rig`` with each camera's lens
   and written as MJPEG .avi by OpenCV's built-in writer (one process per
   camera); ``detection.video._detect_video`` on the port's ``open_video``
   reader (OpenCV's here: no libav) at its default batch for every camera,
   one process per camera at once, and at batches 64, 128 and 256 for the
   first 256 frames of camera 0 alone, frames/s with decode and
   corner-kernel launches per camera; the same detections at every batch;
   camera 0's detections bit-equal to ``detect_chessboard_batch`` on the
   same decoded frames; none on a board-less frame, rate >= 0.98 and
   corner RMS < 0.6 px on detectable views, at most 5% of detections in a
   wrong lattice order; ``_assemble_aligned`` ->
   ``cli._calibrate_from_detections`` (calibrate -> bundle_adjust ->
   compute_residual_metric -> save_calibration) with the corner and both
   BA kernels launched (counts from 0), BA wrapper calls and, under the
   profiler, kernel launches equal to what the solves account for
   (``n_iters``, ``nfev``), both BA kernels against their twins at the
   first kernel-route solve's start, reprojection RMSE,
   residual medians and camera poses relative to camera 0 against the
   truth; JSON (1e-12) and JARVIS round trips, GIMBAL's ImportError naming
   h5py (a round trip where h5py exists); the CLI's ``benchmark`` (platform
   gpu, final cost at most (1 + 1e-5) x the JAX package's on its 995
   frames), ``export`` json -> jarvis -> json and
   ``calibrate``'s ImportError naming h5py;
21. the frame-sharded solve (``parallel/``, ``sharded_phase``): (a)
   ``sharded_lm_solve`` at BASELINE.json config 5's shape (64 cameras x
   20,000 frames x 35 points from ``make_synthetic_rig(64, 20000, seed=11)``,
   started from the truth + N(0, 1e-3) extrinsics), bench options with
   ``frame_chunk=256``, both BA kernels, world size 1 over NCCL, against
   ``lm_solve`` in this process: cost trajectory within 2e-6 (bit-equal
   expected), final cost <= 1.05 x the noise floor, all-reduces and their
   bytes as lm_solve's psum points account for, block / cost launches
   (wrapper = profiler), the device's busy share, peak memory, walls in
   turns; (c) ``sharded_triangulate`` at phase 17's 6 x 1,048,576 points
   within 1e-10 of ``triangulate``, NaN alike; then two spawned ranks on
   cuda:0 over gloo (NCCL refuses two ranks on one device), each starting
   with TF32 on: (b) the bench problem at 922 and 921 frames (461 + 461,
   one padded): the cost trajectory within 5e-5 of ``lm_solve`` over the
   same frame slabs for 3 iterations (the dense solve's difference printed),
   final cost <= 12338.04, ranks bit-identical in n_iters, nfev, history and
   cameras, TF32 off inside their solves; ``bundle_adjust(mesh=...)`` from
   JAX's start: phase 11's frames, cost <= JAX's x (1 + 1e-5), pose repair
   logged as skipped; (c) at two ranks, each held to ``triangulate`` in its
   process; (d) ``distributed_calibration_detection`` on two of phase 20's
   videos (their first 128 frames, one per rank, the corner kernel on each;
   the HDF5 cache left out), bit-equal to both detected in one process;
22. the camera-batched intrinsics stage (``intrinsics_phase``) on a 64 x
   2,000-frame rig (BASELINE.json config 5's cameras, config 3's frames,
   ``make_synthetic_rig(64, 2000, seed=11)``): (a) ``get_intrinsics_batch``
   at 100 samples per camera, a warm-up and the median of 5 calls: the
   lockstep iterations and each lane's ``n_iters`` / ``nfev`` (min, median,
   max) of each batched solve, the cameras the basin guard flags, the LM's
   host reads (gate: one per lockstep try, as the solves' histories count
   them) and, under ``torch.cuda.set_sync_debug_mode``, every synchronising
   call of one call, and the device's busy share under the profiler; (b)
   the per-camera loop of ``get_intrinsics`` once, timed (gates: every
   camera's kept solve's final cost within 1e-7 relative of (a)'s; every
   camera's K within 1e-7 relative and distortion within 1e-6 of (a)'s, but
   for an unstable camera, whose own per-camera solve moves past that gate
   when its detections are scaled by 1 +- 1e-15, and whose K is held within
   10 times that move instead; these are listed); (c) ``calibrate`` on the
   rig (the batched route), the median of 3 calls with its stage times
   (gates: intrinsics before the repair stage equal to (a)'s, the cameras
   the repair refits listed, a tree over all 64 cameras, finite extrinsics,
   each camera's rotation and translation relative to camera 0 within
   CAL_ROT_RAD / CAL_TRANS_MM of the rig's own, and the unstable cameras of
   (b) and those below them in the tree within CAL_UNSTABLE_ROT_RAD /
   CAL_UNSTABLE_TRANS_MM).

Then one line naming the host packages this machine has (h5py, yaml,
pandas, cv2, libavformat; it gates nothing),
one JSON line describing each kernel, with its bound on this card
(the larger of bytes over 3.35 TB/s and operations over the peak rate of
their type: 67 TFLOP/s f32, 34 TFLOP/s f64, NVIDIA's H100 SXM data sheet)
and, for ``pose_gn_kernel``, its device time alone (``alone_us``),
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
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The bench cost at the start over the frames no unstable pose or moved
# camera reaches (measured <= 7e-11 on the CPU, either intrinsics route).
# Over all frames the cost moves with the chaotic poses, so X0_COST_RTOL
# holds the route JAX's start was made on, intrinsics camera by camera.
X0_STABLE_COST_RTOL = 1e-6
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
    "pose_gn_kernel": ("multicam_calibration_tpu_torch/csrc/pose_kernels.cu",
                       "replaces no TPU kernel"),
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
    """A profiler range the code opened (a ``metrics.span``), which the
    trace also mirrors on the device timeline; not device work."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith(
        ("rolling.", "lm_solve.", "ba.", "calibrate.", "detect.", "detect_chessboard_batches.",
         "estimate_pose.", "consensus_calib_poses"))


def relative_extrinsics(ext):
    """Each camera's transform relative to camera 0 (6-vectors): the
    gauge-free part of a rig's extrinsics."""
    from multicam_calibration_tpu_torch.synthetic import _T_to_t6, _t6_to_T

    T0_inv = np.linalg.inv(_t6_to_T(np.asarray(ext)[0]))
    return np.stack([_T_to_t6(_t6_to_T(e) @ T0_inv) for e in np.asarray(ext)])


def transforms(ext):
    """4 x 4 transforms of 6-vector extrinsics (numpy)."""
    from multicam_calibration_tpu_torch.synthetic import _t6_to_T

    return np.stack([_t6_to_T(e) for e in np.asarray(ext)])


def relative_pose_errors(ext, ext_true):
    """Per camera, the rotation angle (rad) and translation distance (mm)
    between its pose relative to camera 0 and the true one: gauge-free, and
    well defined at half turns, where axis-angle vectors are not."""
    from multicam_calibration_tpu_torch.synthetic import _t6_to_T

    def rel(e):
        T0_inv = np.linalg.inv(_t6_to_T(np.asarray(e)[0]))
        return [_t6_to_T(x) @ T0_inv for x in np.asarray(e)]

    rot, trans = [], []
    for A, B in zip(rel(ext), rel(ext_true)):
        cos = (np.trace(A[:3, :3] @ B[:3, :3].T) - 1) / 2
        rot.append(float(np.arccos(np.clip(cos, -1.0, 1.0))))
        trans.append(float(np.linalg.norm(A[:3, 3] - B[:3, 3])))
    return rot, trans


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def launched(kernel):
    """``kernel``'s launches counted so far: the ``utils.metrics`` counter
    ``<kernel>.launches``, raised by one a wrapper call."""
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    return metrics.stage_times.get(f"{kernel}.launches", 0)


def zero_launches(*kernels):
    """Count the launches of ``kernels`` from 0 again."""
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    for kernel in kernels:
        metrics.stage_times[f"{kernel}.launches"] = 0


def uploaded_bytes():
    """The bytes detection has copied to a card so far (``detect.upload_bytes``)."""
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    return metrics.stage_times.get("detect.upload_bytes", 0)


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


def pose_bound(C, F, N):
    """Bound of the pose kernel on (C, F) camera-frames of N points, all of
    them detected: poses, detections, mask and cameras read once, the poses
    written once. Operations in f64, per point and Gauss-Newton step (20
    steps): the prediction ~32 flops (rotate, translate, divide, distort,
    scale), its 6 derivative columns ~171, the 27 sums of J^T J and J^T r
    108; and ~36 a point for each branch's squared error. The rotations,
    factors and solves a frame (~2,000 flops a step) are left out."""
    nbytes = C * F * (6 * 8 * 2 + N * 2 * 8 + 1) + C * 12 * 8 + N * 3 * 8
    return bound(nbytes, [(C * F * N * (20 * (32 + 171 + 108) + 2 * 36), F64_FLOPS)])


def compare_poses(torch, got, args, min_converged=0.9):
    """``pose_gn_refine``'s result ``got`` (C, F, 6) against its twin on the
    same inputs ``args`` (poses0, cam12, uvs, mask, objpoints), at the
    tolerances of tests/test_torch_cuda.py's module docstring; raises on a
    miss. Stable: a converged frame whose twin pose stays within 1e-9 +
    1e-9 of itself when the detections or the camera matrix are scaled by
    1 +- 1e-15 and, for card tensors, when the twin runs on the CPU.
    Returns the counts of camera-frames (detected, converged, unstable:
    converged but not stable, so left out of the 1e-9 comparison;
    other_branch: converged, the other planar branch) and the masks (C, F)
    ``converged`` and ``kept_b`` (the twin kept branch B where A and B
    differ)."""
    from multicam_calibration_tpu_torch.models import initialize as tinit
    from multicam_calibration_tpu_torch.models import lm_core

    def branches(p0, cam, u, m, o):  # the twin's branch A and branch B
        pm = m[:, None].expand(u.shape[:2])
        pa = tinit._refine_poses_gn(p0, cam, u, pm, o)
        return pa, tinit._refine_poses_gn(tinit._twin_planar_pose(pa), cam, u, pm, o)

    def nudged(k, scale):  # the detections (k = 2) or the camera matrix (k = 1) scaled
        out = list(args)
        out[k] = (torch.cat([args[1][:, :4] * scale, args[1][:, 4:]], 1) if k == 1
                  else args[k] * scale)
        return out

    ref = tinit.pose_gn_refine_reference(*args)
    pa, pb = torch.vmap(branches, in_dims=(0, 0, 0, 0, None))(*args)
    others = [tinit.pose_gn_refine_reference(*nudged(k, 1 + e)).cpu().numpy()
              for k in (1, 2) for e in (1e-15, -1e-15)]
    if args[0].device.type != "cpu":  # the twin's other sum order: the CPU's
        others.append(tinit.pose_gn_refine_reference(*(x.cpu() for x in args)).numpy())
    got, ref, pa, pb = (x.cpu().numpy() for x in (got, ref, pa, pb))
    cam12, uvs, objp = args[1].cpu(), args[2].cpu().numpy(), args[4].cpu()
    detected = args[3].cpu().numpy()
    check(np.isnan(got[~detected]).all() and np.isnan(ref[~detected]).all(),
          "pose kernel: an undetected frame is not NaN")
    pred = torch.vmap(lambda c, p: lm_core._predict(c[None], p, objp)[0])(
        cam12, torch.as_tensor(np.nan_to_num(ref))).numpy()
    rms = np.sqrt(((uvs - pred) ** 2).sum(-1).mean(-1))
    seen = ~np.isnan(ref).any(-1)
    converged = seen & (rms < 5.0) & (np.linalg.norm(ref[..., :3], axis=-1) < 2 * np.pi)
    check(converged.sum() >= min_converged * detected.sum(),
          f"pose twin: {converged.sum()} of {detected.sum()} detected frames converged")
    check(not np.isnan(got[converged]).any(), "pose kernel: NaN on a frame the twin converged")
    close = lambda a, b: (np.abs(a - b) <= 1e-9 + 1e-9 * np.abs(b)).all(-1)  # noqa: E731
    stable = converged.copy()
    for other in others:
        stable &= close(np.nan_to_num(other), ref)
    unstable = int((converged & ~stable).sum())
    check(unstable <= max(1, 0.01 * converged.sum()),
          f"pose twin: {unstable} of {converged.sum()} converged frames unstable")
    dist = lambda a, b: np.abs(a - b).max(-1)  # noqa: E731
    twins_agree = close(pb, pa)
    same_branch = twins_agree | ((dist(got, pb) < dist(got, pa)) == (dist(ref, pb) < dist(ref, pa)))
    check(same_branch[converged].mean() >= 0.99,
          f"pose kernel: {(~same_branch[converged]).sum()} converged frames on the other branch")
    keep = stable & same_branch
    err = np.abs(got[keep] - ref[keep]) - 1e-9 * np.abs(ref[keep])
    check(not (err > 1e-9).any(), f"pose kernel: {(err > 1e-9).any(-1).sum()} stable frames "
          f"beyond rtol 1e-9 / atol 1e-9 (worst {err.max(initial=0.0):.3e})")
    return dict(detected=int(detected.sum()), converged=int(converged.sum()), unstable=unstable,
                other_branch=int((converged & ~same_branch).sum()),
                max_abs=float(np.abs(got[keep] - ref[keep]).max(initial=0.0)),
                converged_mask=converged, kept_b=converged & ~twins_agree & (dist(ref, pb) == 0))


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


def profiled(torch, fn, what, cpu=True):
    """(fn(), the profiler) of one run of fn under torch.profiler (CPU, unless
    ``cpu`` is false, and CUDA), synchronised before the session stops. A
    session in which the profiler recorded no device work at all lost its
    trace, not the work: it is reported and fn is run again, in
    PROFILE_TRIES sessions at most."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for k in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
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


def kernel_alone_us(torch, fn, kernel, calls=10):
    """(mean device us of one ``kernel`` launch, launches the profiler
    recorded) over ``calls`` calls of fn() under torch.profiler, after a
    warm-up: the mean is over the launches recorded, so a session that
    drops some does not lower it."""
    fn()
    torch.cuda.synchronize()
    _, prof = profiled(torch, lambda: [fn() for _ in range(calls)], f"{kernel} alone")
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name) == kernel]
    return sum(us) / max(1, len(us)), len(us)


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
        before = launched("corner_peaks_kernel")
        out = mct.detect_chessboard_batch(list(images), board_shape=board, device=dev)
        return out, launched("corner_peaks_kernel") - before

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
    zero_launches("corner_peaks_kernel", "corner_response_kernel")
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
    launches["corner_peaks_kernel"] = launched("corner_peaks_kernel")
    launches["corner_response_kernel"] = launched("corner_response_kernel")
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


def start_gates(torch, dev, rig, cal, ref, x0, cost_rtol=X0_COST_RTOL):
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
    at the port's start within X0_STABLE_COST_RTOL of the cost at JAX's over
    the frames no moved camera nor unstable pose reaches, and within
    ``cost_rtol`` over all frames (measured, not held, where it is None)."""
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
    def cost_at(cam, p, frames):
        m = problem[1] & as_t(frames)[None, :, None]
        return float(lm_core.compute_cost(as_t(cam), as_t(p), problem[0], m, problem[2],
                                          lm_core.LMOptions()))

    port, jax_x0 = (cam0, np.nan_to_num(poses[uf])), (jcam, x0["poses0"])
    s_port, s_jax = cost_at(*port, ~explained), cost_at(*jax_x0, ~explained)
    check(abs(s_port - s_jax) <= X0_STABLE_COST_RTOL * s_jax,
          f"cost at the port's start {s_port} vs JAX's {s_jax} over the frames no moved "
          "camera nor unstable pose reaches")
    every = np.ones(len(uf), bool)
    c_port, c_jax = cost_at(*port, every), cost_at(*jax_x0, every)
    check(cost_rtol is None or abs(c_port - c_jax) <= cost_rtol * c_jax,
          f"cost at the port's start {c_port} vs JAX's {c_jax}")
    return dict(intr_rel=intr_rel, rot=rot, trans=trans, moved=moved.tolist(),
                allowed=sorted(allowed), pose_err=pose_err, differ=int(differ.sum()),
                explained=int(explained.sum()), frames=len(uf), c_port=c_port, c_jax=c_jax,
                s_port=s_port, s_jax=s_jax)


def calibrate_phase(torch, dev):
    """Phase 10: the port's calibrate on the bench rig against JAX's, on its
    batched route and with the intrinsics solved camera by camera."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.models import initialize
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
    g = start_gates(torch, dev, rig, out, ref, x0, cost_rtol=None)
    # The same calibrate with get_intrinsics camera by camera in place of the
    # lockstep batch: JAX's start (data/bench_x0.npz) was made on that route.
    batch = initialize.get_intrinsics_batch
    initialize.get_intrinsics_batch = lambda uvs, objp, sizes, n_samples, device: [
        initialize.get_intrinsics(uvs[c], objp, sizes[c], n_samples=n_samples, device=device)
        for c in range(len(uvs))]
    try:
        loop_out, loop_wall = timed(torch, call)
    finally:
        initialize.get_intrinsics_batch = batch
    gl = start_gates(torch, dev, rig, loop_out, ref, x0)
    rel = lambda a, b: f"{(a - b) / b:+.2e}"  # noqa: E731
    pe = g["pose_err"]
    log("10 calibrate", f"{RIG['n_cameras']} x {RIG['n_frames']} x {rig.calib_objpoints.shape[0]}, "
        f"n_samples_for_intrinsics {N_SAMPLES_FOR_INTRINSICS}: tree {out[3]} as JAX; intrinsics "
        f"max rel diff {g['intr_rel']:.3e}; extrinsics max |diff| {g['rot']:.3e} rad, "
        f"{g['trans']:.3e} mm, cameras off JAX's {g['moved']} (allowed {g['allowed']}: "
        f"{int(ref['pose_unstable'].sum())} unstable camera-frames in JAX); poses at the "
        f"{g['frames']} bench frames: {g['differ']} differ (all among the {g['explained']} seen by "
        f"a moved camera or holding an unstable pose), median max|diff| {np.median(pe):.3e}, 90th "
        f"percentile {np.percentile(pe, 90):.3e}, max {pe.max():.3e}; bench cost at the start "
        f"over the {g['frames'] - g['explained']} frames no moved camera nor unstable pose "
        f"reaches {g['s_port']:.4f} vs JAX's {g['s_jax']:.4f} (rel {rel(g['s_port'], g['s_jax'])}; "
        f"gate {X0_STABLE_COST_RTOL:g}), over all frames {g['c_port']:.4f} vs {g['c_jax']:.4f} "
        f"(rel {rel(g['c_port'], g['c_jax'])}; not held on this route); wall " + walls_text(walls)
        + f", warm-up {warm:.4f} s; stages per call: {stages}")
    log("10 calibrate, intrinsics per camera", f"wall {loop_wall:.4f} s; intrinsics max rel "
        f"diff {gl['intr_rel']:.3e}, extrinsics {gl['rot']:.3e} rad, {gl['trans']:.3e} mm, "
        f"cameras off JAX's {gl['moved']}; poses: {gl['differ']} differ (of the "
        f"{gl['explained']} allowed), max {gl['pose_err'].max():.3e}; bench cost at the start "
        f"over the {gl['frames'] - gl['explained']} stable frames rel "
        f"{rel(gl['s_port'], gl['s_jax'])} (gate {X0_STABLE_COST_RTOL:g}), over all frames "
        f"{gl['c_port']:.4f} vs JAX's {gl['c_jax']:.4f} (rel {rel(gl['c_port'], gl['c_jax'])}; "
        f"gate {X0_COST_RTOL:g})")
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
                                     lm_core.ba_chunk_blocks_reference(*args, **kw))
        cerr, trel = compare_cost(ba_cuda.ba_chunk_cost(*args, **kw),
                                  lm_core.ba_chunk_cost_reference(*args, **kw),
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
        before = (launched("ba_blocks_kernel"), launched("ba_cost_kernel"))
        s_ext, s_intr, s_poses = start
        (a_ext, a_intr, a_poses, uf, info), wall = timed(torch, lambda: mct.bundle_adjust(
            rig.all_calib_uvs, s_ext, s_intr, rig.calib_objpoints, s_poses, verbose=False,
            device=dev, **kw))
        nb = launched("ba_blocks_kernel") - before[0]
        nc = launched("ba_cost_kernel") - before[1]
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
        zero_launches("ba_blocks_kernel", "ba_cost_kernel")
        main = run(port_start)
        check(launched("ba_blocks_kernel") > 0 and launched("ba_cost_kernel") > 0,
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
        before = (launched("corner_peaks_kernel"), uploaded_bytes())
        out, wall = timed(torch, lambda: mct.detect_chessboard_batch(
            list(images), board_shape=board, coarse_downscale=f, device=dev))
        return (out, wall, launched("corner_peaks_kernel") - before[0],
                uploaded_bytes() - before[1])

    for f in LOWBAND_F:
        got = detect(d["frames"], f)[0]
        du = same_as_stored(got, low[f"low{f}_accepted"], low[f"low{f}_uvs"],
                            low[f"low{f}_scores"], f"stored frames f={f}")
        log(f"12 parity f={f}", f"{len(d['frames'])} stored frames: accepted "
            f"{len(got)}/{len(d['frames'])} as JAX's low-band run; max |corner diff| {du:.2e} px")

    for f in (1,) + LOWBAND_F:
        detect(batches[0], f)  # warm-up
    res = {f: [] for f in (1,) + LOWBAND_F}
    zero_launches("corner_peaks_kernel")  # the low-band main path, read after the loop
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
        zero_launches("corner_peaks_kernel")  # the streamed main path, read just after
        got = streamed(f)
        check(launched("corner_peaks_kernel") > 0, "streaming did not launch the corner kernel")
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
        zero_launches("corner_peaks_kernel")  # the scale_factor main path, read just after
        walls, out = [], {}
        for i, fr in enumerate(frames):
            r, w = timed(torch, lambda: mct.detect_chessboard(fr, board_shape=board, scale_factor=s,
                                                              device=dev))
            walls.append(w)
            if r is not None:
                out[i] = r
        n = launched("corner_peaks_kernel")
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


def rolling_phase(torch, dev, ref, errs, launches, times, bounds):
    """Phase 19: RollingCalibrator, the f64 check against JAX and BASELINE
    config 4 at bench_streaming.py's shape through both BA kernels and the
    pose kernel; the pose kernel's entries of ``launches`` / ``errs`` /
    ``times`` / ``bounds``."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.models import initialize, lm_core, streaming
    from multicam_calibration_tpu_torch.ops import ba_cuda

    solves = []  # (start arrays, options, info) of every lm_solve of an update
    polishes = []  # the arguments of every pose_gn_refine call of the pose init
    lm_solve, pose_gn_refine = streaming.lm_solve, initialize.pose_gn_refine

    def recording_lm_solve(*args, **kwargs):
        out = lm_solve(*args, **kwargs)
        solves.append((args[:5], args[5], out[2]))
        return out

    def recording_pose_gn_refine(*args):
        polishes.append(args)
        return pose_gn_refine(*args)

    streaming.lm_solve = recording_lm_solve
    initialize.pose_gn_refine = recording_pose_gn_refine
    try:
        # The f64 check: JAX's options carried over, per-update state as JAX's.
        p = STREAM_F64
        rig = mct.make_synthetic_rig(n_cameras=p["n_cameras"], n_frames=p["n_frames"],
                                     noise_px=NOISE_PX, dropout=0.25, seed=p["seed"])
        ext, intr = stream_start(rig, p["seed"])
        opts = lm_options_from_jax(json.loads(str(ref["stream_options"])))
        rc = mct.RollingCalibrator(ext, intr, rig.calib_objpoints, window=p["window"],
                                   protect_recent=p["protect"], lm_options=opts, device=dev)
        before = (launched("ba_blocks_kernel"), launched("ba_cost_kernel"))
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
        check((launched("ba_blocks_kernel"), launched("ba_cost_kernel")) == before,
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
        polishes.clear()
        zero_launches("pose_gn_kernel")
        for k in range(p["timed"]):
            solves.clear()
            nb0, nc0 = launched("ba_blocks_kernel"), launched("ba_cost_kernel")
            info, wall = timed(torch, lambda: rc.update(next(batches)))
            nb = launched("ba_blocks_kernel") - nb0
            nc = launched("ba_cost_kernel") - nc0
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
                                           lm_core.ba_chunk_blocks_reference),
                      "ba_cost_kernel": (ba_cuda.ba_chunk_cost, lm_core.ba_chunk_cost_reference)}
                ktimes = {name: (cuda_ms(torch, lambda f=f: f(*args)),
                                 cuda_ms(torch, lambda r=r: r(*args)),
                                 profile_calls(torch, lambda f=f: f(*args))[1])
                          for name, (f, r) in kt.items()}
                kbounds = ba_bounds(p["n_cameras"], p["window"], rig.calib_objpoints.shape[0],
                                    int(start[3].sum()))
        n_pose = launched("pose_gn_kernel")
        check(n_pose == len(polishes) == p["timed"],
              f"pose_gn_kernel launches {n_pose} in {p['timed']} timed updates")
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
            check(names.count("pose_gn_kernel") == 1,
                  f"profiler: {names.count('pose_gn_kernel')} pose_gn_kernel launches an update")
            prof_counts.append(f"{nk[0]}/{nk[1]}/1 of {len(dev_ev)} device ops")
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
        initialize.pose_gn_refine = pose_gn_refine

    # The pose kernel on the first timed update's own inputs: the homography
    # stage's poses, the cameras, detections and mask of 64 x 8 x 35.
    pargs = polishes[0]
    pC, pF, pN = pargs[2].shape[:3]
    pose = compare_poses(torch, pose_gn_refine(*pargs), pargs)
    errs["pose_gn_kernel"] = pose["max_abs"]
    launches["pose_gn_kernel"] = n_pose
    times["pose_gn_kernel"] = (cuda_ms(torch, lambda: pose_gn_refine(*pargs)),
                               cuda_ms(torch, lambda: initialize.pose_gn_refine_reference(*pargs),
                                       reps=3))
    pose_alone_us, pose_recorded = kernel_alone_us(torch, lambda: pose_gn_refine(*pargs),
                                                   "pose_gn_kernel")
    bounds["pose_gn_kernel"] = pose_bound(pC, pF, pN)

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
        f"{p['batch']} (BASELINE.json config 4, scripts/bench_streaming.py:16-19), f32 recipe, "
        "the pose polish through pose_gn_kernel: "
        f"fill {n_fill} updates in {fill_s:.3f} s; {p['timed']} timed updates: median "
        + walls_text(walls).removeprefix("median ") + "; per update n_iters/nfev = block/cost "
        "launches " + ", ".join(f"{r[1]['n_iters']}/{r[2]}/{r[3]}" for r in rows)
        + f"; costs " + ", ".join(f"{r[1]['cost']:.1f}" for r in rows)
        + f"; final cost {cost:.1f} <= 1.05 x noise floor {floor_cost:.1f} over {n_obs} "
        f"effective observations (ratio {cost / floor_cost:.4f}); relative extrinsics vs truth: "
        f"rotation max {rot:.2e} rad, translation max {trans:.4f} mm; pose_gn_kernel launches "
        f"{n_pose} in {p['timed']} timed updates; profiler ba_blocks/ba_cost/pose_gn launches = "
        "n_iters/nfev/1 on " + ", ".join(prof_counts)
        + "; profiled updates (ms): " + " | ".join(splits))
    log("19 kernels", f"at the window's first timed update, C={p['n_cameras']} F={p['window']} "
        f"N={rig.calib_objpoints.shape[0]}: " + held + "; ms per call wrapper vs twin, kernels "
        "alone (profiler), bound: " + "; ".join(
            f"{k} {a:.4f} vs {b:.4f}, alone {1e3 * dev_ms:.2f} us, bound {kbounds[k][0]:.5f} "
            f"ms ({kbounds[k][1]})" for k, (a, b, dev_ms) in ktimes.items()))
    pw, pt = times["pose_gn_kernel"]
    log("19 pose kernel", f"at the first timed update's pose init, C={pC} F={pF} N={pN}: "
        f"pose_gn_kernel vs twin on {pose['detected']} detected camera-frames, "
        f"{pose['converged']} converged in the twin, {pose['unstable']} of them unstable (left "
        f"out of the 1e-9 comparison), {pose['other_branch']} on the other planar branch, "
        f"max|diff| {pose['max_abs']:.3e} on the rest; ms per call wrapper {pw:.4f} vs twin "
        f"{pt:.4f}, alone {pose_alone_us:.2f} us (mean of the {pose_recorded} of 10 launches "
        f"the profiler recorded), bound {bounds['pose_gn_kernel'][0]:.5f} ms "
        f"({bounds['pose_gn_kernel'][1]}); launches on the main path {n_pose}, one an update")
    return {"pose_gn_kernel": pose_alone_us}
    log("16 uncertainty window", f"phase 19's window ({p['n_cameras']} cameras x {p['window']} "
        f"frames, S {12 * p['n_cameras']} x {12 * p['n_cameras']}), f64: wall "
        + walls_text(uwalls) + f", warm-up {uwarm:.4f} s, sigma {unc['sigma_px']:.4f} px")


# Phase 20: the lab's path from videos to a saved calibration. The rig is
# the bench rig's construction (synthetic.make_synthetic_rig: a ring of 6
# cameras, f = 900 px, radial distortion, a tumbling 5 x 7 board of 12.5 mm
# squares, noise 0.3 px, dropout 0.25, seed 11) at a ring radius and board
# excursion a 640 x 480 camera resolves (the bench rig's 750 mm ring and
# +-700 mm excursions leave 2-19 px between corners), and camera 3 where the
# ring puts it (see video_rig). 600 frames per camera (20 s at 30 fps): at
# 300 a CPU rehearsal left camera 1 with 29 detections, 5 in a wrong order,
# and bundle_adjust dropped all its frames (PERF.md §6).
VIDEO = dict(n_cameras=6, n_frames=600, radius_mm=500.0, excursion_mm=40.0,
             img_size=(640, 480), noise_px=0.3, dropout=0.25, seed=11)
# Every camera runs at _detect_video's default batch (video.BATCH_SIZE), one
# process per camera at once: the main path. On the card the detector takes
# ~100 ms a frame here, mostly host lattice search on board-less frames
# (PERF.md §5), so the batch comparison (behind the default's choice) and
# the equality gate run on the first VIDEO_SWEEP_FRAMES frames of camera
# VIDEO_SWEEP_CAMERA only.
VIDEO_BATCHES, VIDEO_SWEEP_CAMERA, VIDEO_SWEEP_FRAMES = (64, 128, 256), 0, 256
VIDEO_SPLIT_FRAMES = 64
VIDEO_BOARD = (5, 7)
# A view is "detectable" when the board faces the camera at most
# VIDEO_TILT_DEG off the line of sight, the whole board (its sheet, margins
# and anchor included) lies VIDEO_MARGIN_PX inside the image and no two
# neighbouring corners are closer than VIDEO_PITCH_PX; the rate is gated
# there (a CPU rehearsal found recall 1.0 below 45 degrees, 0.70 at 45-60
# and 0.10 beyond), and so is the corner error of the detections there. On
# steeper views the detector (the JAX package's, which the port reproduces)
# sometimes accepts a wrong lattice order; their share of all detections is
# gated at VIDEO_WRONG_MAX (a detection is wrong when its corners lie more
# than VIDEO_WRONG_PX RMS from the truth in the true order).
VIDEO_MARGIN_PX, VIDEO_PITCH_PX, VIDEO_TILT_DEG = 10, 8.0, 45.0
VIDEO_RATE, VIDEO_RMS_PX = 0.98, 0.6
VIDEO_WRONG_MAX, VIDEO_WRONG_PX = 0.05, 2.0
# Calibration gates, written into PERF.md before the first card run from CPU
# rehearsals of this phase at 6 x 60 and 6 x 600 frames (RMSE 0.0990 / 0.1576
# px, medians <= 0.0160 / 0.0252 mm, poses relative to camera 0 within 0.093 /
# 0.0048 rad and 71.7 / 3.47 mm; 60 frames leave 22 for bundle_adjust).
VIDEO_RMSE_PX, VIDEO_MEDIAN_MM, VIDEO_ROT_RAD, VIDEO_TRANS_MM = 0.3, 0.1, 0.01, 7.0
CLI_BENCH = ["benchmark", "--n-cameras", "6", "--n-frames", "1000"]
IO_ATOL = 1e-12  # a saved and loaded calibration: transforms (mm), K (px), dist
# The JAX package's ``benchmark`` on the same problem (6 cameras, the 995
# frames seen whole by >= 2 cameras; ``python -m multicam_calibration_tpu.cli
# benchmark --n-cameras 6 --n-frames 1000`` on the CPU, f64): its final cost.
# SCIPY_TRF_COST is the bench problem's (922 frames, outliers dropped), not
# this one's.
CLI_BENCH_JAX_COST = 13247.102977388131


def video_rig(n_cameras, n_frames, radius_mm, excursion_mm, img_size, noise_px, dropout, seed):
    """``make_synthetic_rig``'s construction, step for step, with the ring
    radius and the board trajectory's scale given, and the rebase onto
    camera 0 through ``so3_log``: ``synthetic._rotmat_to_rotvec`` returns
    no rotation for a half turn, which turns the camera opposite camera 0
    (camera 3 of 6) to face camera 0's way from behind it."""
    import torch

    from multicam_calibration_tpu_torch import synthetic as syn
    from multicam_calibration_tpu_torch.detection.board import generate_chessboard_objpoints
    from multicam_calibration_tpu_torch.ops.transforms import get_transformation_vector

    def t6(T):
        return get_transformation_vector(torch.as_tensor(T)).numpy()

    rng = np.random.default_rng(seed)
    objp = generate_chessboard_objpoints(VIDEO_BOARD, 12.5)
    ext, intr, sizes = syn.make_camera_ring(n_cameras, radius=radius_mm,
                                            height=radius_mm * 0.35, img_size=img_size, rng=rng)
    poses = syn.make_board_trajectory(n_frames, rng=rng, scale=excursion_mm)
    poses[:, 3:] -= objp.mean(0)
    T0 = syn._t6_to_T(ext[0])  # camera 0's frame is the world frame
    ext = np.stack([t6(syn._t6_to_T(e) @ np.linalg.inv(T0)) for e in ext])
    poses = np.stack([t6(T0 @ syn._t6_to_T(p)) for p in poses])
    uvs = syn.render_observations(ext, intr, sizes, poses, objp, noise_px=noise_px,
                                  dropout=dropout, rng=rng)
    return syn.SyntheticRig(ext, intr, poses, objp, uvs, sizes)


def _lattice(uv, rows):
    """(cols, rows, 2) grid of a board's corners (corner k = c * rows + r)."""
    return np.asarray(uv).reshape(-1, rows, 2)


def render_camera(path, rig_arrays, cam, board_shape, seed):
    """Render one camera's views of the rig to an MJPEG .avi with OpenCV's
    built-in writer (3-channel frames: its grayscale mode writes corrupt
    frames in some OpenCV builds) and return (truth (F, N, 2), shown (F,),
    detectable (F,), dropped (F,), writer backend). A view shows the board
    where the board is in front of the camera, faces it (its image is not
    mirrored) and the rig did not drop it; every other view is rendered with
    the board outside the picture. Runs in a worker process."""
    import cv2

    from multicam_calibration_tpu_torch.detection import synthetic_images as si
    from multicam_calibration_tpu_torch.detection.synthetic_images import (
        distort_pixels, render_board_image, render_board_view)
    from multicam_calibration_tpu_torch.synthetic import _project_np, _t6_to_T

    cv2.setNumThreads(1)
    ext, K, dist, poses, objp, uvs, (w, h) = rig_arrays
    rows, _ = board_shape
    sheet_img, can = render_board_image(board_shape, 40)
    sheet = np.array([[0.0, 0.0, 1.0], [sheet_img.shape[1], 0, 1], [sheet_img.shape[1],
                      sheet_img.shape[0], 1], [0, sheet_img.shape[0], 1]])
    Tc = _t6_to_T(ext)
    off = np.array([[1.0, 0, 1e5], [0, 1.0, 1e5], [0, 0, 1.0]])  # board far off-image
    # render_board_view computes its lens's undistort map for every view:
    # this camera's is computed once and served to each of its views.
    lens_map, undistort_pixel_map = si.undistort_pixel_map((h, w), K, dist), si.undistort_pixel_map
    si.undistort_pixel_map = lambda *args, **kwargs: lens_map
    try:
        writer = cv2.VideoWriter(path, cv2.CAP_OPENCV_MJPEG, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                                 (w, h), True)
        check(writer.isOpened(), f"cv2 cannot write {path} with its built-in MJPEG backend")
        F, N = len(poses), len(objp)
        truth = np.full((F, N, 2), np.nan)
        shown, detectable, dropped = (np.zeros(F, bool) for _ in range(3))
        for f in range(F):
            Tb = _t6_to_T(poses[f])
            world = objp @ Tb[:3, :3].T + Tb[:3, 3]
            in_cam = world @ Tc[:3, :3].T + Tc[:3, 3]
            z = in_cam[:, 2]
            normal = Tc[:3, :3] @ Tb[:3, :3][:, 2]
            ray = in_cam.mean(0)
            tilt = np.degrees(np.arccos(min(1.0, abs(normal @ ray) / np.linalg.norm(ray))))
            ideal = _project_np(world, ext, K, np.zeros(5))
            real = _project_np(world, ext, K, dist)
            inside = lambda p, m: bool((p >= m).all() and (p[:, 0] < w - m).all()  # noqa: E731
                                       and (p[:, 1] < h - m).all())
            in_front = bool((z > 0.05).all())
            dropped[f] = in_front and inside(real, 0) and np.isnan(uvs[f]).any()
            g = _lattice(ideal, rows)
            e_c, e_r = np.diff(g, axis=0).mean((0, 1)), np.diff(g, axis=1).mean((0, 1))
            shown[f] = in_front and not dropped[f] and e_c[0] * e_r[1] - e_c[1] * e_r[0] > 0
            H = off
            if shown[f]:
                A = []
                for (x, y), (u, v) in zip(can, ideal):
                    A += [[x, y, 1, 0, 0, 0, -u * x, -u * y, -u],
                          [0, 0, 0, x, y, 1, -v * x, -v * y, -v]]
                H = np.linalg.svd(np.asarray(A))[2][-1].reshape(3, 3)
            view, gt = render_board_view(H, (h, w), board_shape=board_shape, camera_matrix=K,
                                         dist_coefs=dist, seed=seed + f)
            if shown[f]:
                truth[f] = gt
                gl = _lattice(gt, rows)
                pitch = min(np.linalg.norm(np.diff(gl, axis=a), axis=-1).min() for a in (0, 1))
                corners = sheet @ H.T
                corners = distort_pixels(corners[:, :2] / corners[:, 2:], K, dist)
                detectable[f] = (inside(corners, VIDEO_MARGIN_PX) and pitch >= VIDEO_PITCH_PX
                                 and tilt <= VIDEO_TILT_DEG)
            writer.write(cv2.cvtColor(view.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        name = writer.getBackendName()
        writer.release()
    finally:
        si.undistort_pixel_map = undistort_pixel_map
    return truth, shown, detectable, dropped, name


def map_in_processes(fn, *iterables):
    """``list(map(fn, *iterables))`` in spawned worker processes, one per
    item up to the host's cores, each with one BLAS / OpenMP thread (six
    workers each spinning a thread per core made the render 5-7x slower);
    the workers read that from the environment at start. Every worker has
    ended when this returns."""
    import multiprocessing

    items = list(zip(*iterables))
    threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                              "MKL_NUM_THREADS")}
    os.environ.update(dict.fromkeys(threads, "1"))
    try:
        with concurrent.futures.ProcessPoolExecutor(
                min(len(items), os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(fn, *zip(*items)))
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def render_rig_videos(directory, rig):
    """One worker process per camera renders and writes its video. Returns
    (paths, truth (C, F, N, 2), shown, detectable, dropped, backends)."""
    objp = rig.calib_objpoints
    paths = [os.path.join(directory, f"cam{c}.avi") for c in range(rig.n_cameras)]
    args = [(paths[c], (rig.all_extrinsics[c], *rig.all_intrinsics[c], rig.calib_poses, objp,
                        rig.all_calib_uvs[c], rig.img_sizes[c]), c, VIDEO_BOARD, 1000 * c)
            for c in range(rig.n_cameras)]
    out = map_in_processes(render_camera, *zip(*args))
    *arrays, backends = zip(*out)
    return (paths, *(np.stack(a) for a in arrays), list(backends))


def detect_camera(path):
    """One camera's detection on the main path, in a worker process:
    ``_detect_video`` on the card at its default batch, with the corner
    kernel's launches counted from 0 just before and read just after.
    Returns (its detections, those launches, its seconds)."""
    import torch

    from multicam_calibration_tpu_torch.detection import video
    from multicam_calibration_tpu_torch.device import cuda_device

    dev = cuda_device()
    zero_launches("corner_peaks_kernel")
    out, wall = timed(torch, lambda: video._detect_video(
        path, video.detect_chessboard, {"board_shape": VIDEO_BOARD}, device=dev))
    return out, launched("corner_peaks_kernel"), wall


def decoded_frames(path):
    """Every frame of a video through the port's cv2 reader, in order."""
    from multicam_calibration_tpu_torch.detection.video import VideoReader

    reader = VideoReader(path)
    try:
        return [reader[i] for i in range(len(reader))]
    finally:
        reader.close()


def video_phase(torch, dev, errs, keep_dir):
    """Phase 20: rendered videos -> ``_detect_video`` (corner kernel) ->
    ``_assemble_aligned`` -> ``cli._calibrate_from_detections`` (both BA
    kernels) -> ``save_calibration`` / ``load_calibration``, then the CLI.
    Returns copies in ``keep_dir`` of the first SHARD_VIDEOS videos (phase
    21d's input)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import cv2

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch import cli
    from multicam_calibration_tpu_torch.detection import native_video, video
    from multicam_calibration_tpu_torch.models import bundle_adjustment, initialize, lm_core
    from multicam_calibration_tpu_torch.utils.config import PipelineConfig
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    rig = video_rig(**VIDEO)
    C, F = rig.n_cameras, rig.n_frames
    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        (paths, truth, shown, detectable, dropped, backends), t_render = timed(
            torch, lambda: render_rig_videos(tmp, rig))
        check(set(backends) == {"CV_MJPEG"}, f"video writer backends {backends}")
        reader = video.open_video(paths[0])
        serving = f"{reader.backend} ({getattr(reader, 'api', 'libav')}), {len(reader)} frames"
        check(len(reader) == F, f"a video holds {len(reader)} frames, not {F}")
        reader.close()
        log("20 videos", f"{C} cameras x {F} frames of {VIDEO['img_size'][0]}x"
            f"{VIDEO['img_size'][1]}, rendered and written in {t_render:.2f} s by {C} "
            f"processes with cv2 {cv2.__version__} {backends[0]} (MJPG); board shown in "
            f"{int(shown.sum())} views, {int(detectable.sum())} detectable, {int(dropped.sum())} "
            f"dropped by the rig (board-less); reader: {serving}; native runtime: "
            + ("available" if native_video.available() else "unavailable ("
               + (native_video.build_error() or "").strip().splitlines()[-1][:160] + ")"))

        # The main path's detection: every camera at the default batch, one
        # process per camera at once, each counting its corner-kernel
        # launches from 0 (the BA kernels' counts start at 0 here, for the
        # calibration).
        options = {"board_shape": VIDEO_BOARD}
        zero_launches("ba_blocks_kernel", "ba_cost_kernel")
        B0, c0, F0 = video.BATCH_SIZE, VIDEO_SWEEP_CAMERA, min(VIDEO_SWEEP_FRAMES, F)
        found, t_detect = timed(torch, lambda: map_in_processes(detect_camera, paths))
        main, launches, walls = (list(x) for x in zip(*found))
        for c, n in enumerate(launches):
            check(n >= -(-F // B0), f"camera {c}: {n} corner-kernel launches")
        corner_main = sum(launches)
        log(f"20 detect batch {B0}", f"{C} processes at once, {C * F / t_detect:.1f} frames/s "
            f"with decode over the pool's {t_detect:.1f} s (process start included); per "
            "camera " + ", ".join(f"{F / w:.1f}" for w in walls) + " frames/s in its process "
            f"({C * F / sum(walls):.1f} over their summed time); corner-kernel launches per "
            "camera " + ", ".join(map(str, launches)) + "; detections per camera "
            + ", ".join(str(len(o[1])) for o in main))
        # The batch comparison on camera c0's first F0 frames, in this
        # process alone.
        sweep = {B: [] for B in VIDEO_BATCHES}
        for B in VIDEO_BATCHES:
            out, wall = timed(torch, lambda: video._detect_video(
                paths[c0], video.detect_chessboard, options, use_frames=np.arange(F0),
                batch_size=B, device=dev))
            sweep[B].append((F0 / wall, out))
        rates = {B: statistics.median(r for r, _ in runs) for B, runs in sweep.items()}
        best = max(rates, key=rates.get)
        first = main[c0][1] < F0
        same_batches = all(np.array_equal(o[1], main[c0][1][first])
                           and np.allclose(o[0], main[c0][0][first], rtol=0, atol=1e-6)
                           for runs in sweep.values() for _, o in runs)
        log("20 detect batches", f"camera {c0}, frames 0-{F0 - 1}, frames/s with decode: "
            + "; ".join(
                f"batch {B} " + ", ".join(f"{r:.1f}" for r, _ in runs)
                for B, runs in sweep.items()) + f"; fastest {best}")
        check(same_batches, f"camera {c0}: batches {VIDEO_BATCHES} detect different frames or "
              "corners more than 1e-6 px apart")

        # Gates: _detect_video at the default batch in this process equal
        # to detect_chessboard_batch on the same decoded frames (the worker
        # processes run one BLAS thread, this one several), no board-less
        # detection, rate on detectable views, corner error.
        uvs, fixs, _, qc = sweep[B0][0][1]
        frames = decoded_frames(paths[c0])
        ref = {}
        for lo in range(0, F0, B0):
            chunk = frames[lo:min(lo + B0, F0)]
            chunk += [chunk[-1]] * (B0 - len(chunk))
            for j, (u, q) in mct.detect_chessboard_batch(
                    chunk, board_shape=VIDEO_BOARD, device=dev).items():
                if lo + j < F0:
                    ref[lo + j] = (u, q)
        check(sorted(ref) == fixs.tolist(), f"camera {c0}: frames differ from "
              "detect_chessboard_batch's")
        check(all(np.array_equal(ref[i][0], u) and np.array_equal(ref[i][1], q)
                  for i, u, q in zip(fixs.tolist(), uvs, qc)),
              f"camera {c0}: detections differ from detect_chessboard_batch's")
        # Where the time goes: one call on board-less frames, one on frames
        # showing the board, from camera c0's video.
        split = {}
        for label, pick in (("board-less", ~shown[c0]), ("board shown", shown[c0])):
            ix = np.nonzero(pick)[0][:VIDEO_SPLIT_FRAMES]
            _, wall = timed(torch, lambda: mct.detect_chessboard_batch(
                [frames[i] for i in ix], board_shape=VIDEO_BOARD, device=dev))
            split[label] = (len(ix), 1e3 * wall / max(len(ix), 1))
        del frames
        err, hits = np.full((C, F), np.nan), np.zeros((C, F), bool)
        for c in range(C):
            uvs, fixs, size, qc = main[c]
            check(tuple(size) == tuple(VIDEO["img_size"]), f"img_size {size}")
            hits[c, fixs] = True
            err[c, fixs] = np.sqrt(((uvs - truth[c, fixs]) ** 2).sum(-1).mean(-1))
        false = int((hits & ~shown).sum())
        check(false == 0, f"{false} detections on board-less frames")
        rate = float(hits[detectable].mean())
        check(rate >= VIDEO_RATE, f"detection rate {rate:.4f} on detectable views")
        on_det = err[hits & detectable]
        rms = float(np.sqrt(np.mean(on_det ** 2)))
        check(rms < VIDEO_RMS_PX, f"corner error RMS {rms:.4f} px on detectable views")
        wrong = hits & (err > VIDEO_WRONG_PX)
        share = float(wrong.sum() / hits.sum())
        check(share <= VIDEO_WRONG_MAX, f"{int(wrong.sum())} of {int(hits.sum())} detections "
              "in a wrong lattice order")
        rms_ok = float(np.sqrt(np.mean(err[hits & ~wrong] ** 2)))
        log("20 detection gates", f"batch {B0} (the default; camera {c0}'s first {F0} "
            "frames: the same frames at every batch, corners within 1e-6 px, and bit-equal to "
            "detect_chessboard_batch on the decoded frames); one call "
            + "; ".join(f"on {n} {k} frames {ms:.1f} ms a frame" for k, (n, ms) in split.items())
            + "; "
            f"{int(hits.sum())} detections, 0 on the {int((~shown).sum())} board-less frames; "
            f"rate {rate:.4f} on the {int(detectable.sum())} detectable views (board shown: "
            f"{float(hits[shown].mean()):.4f} of {int(shown.sum())}); corner "
            f"error RMS {rms:.4f} px on detectable views, {rms_ok:.4f} px on all but the "
            f"{int(wrong.sum())} in a wrong order ({share:.4f}; per camera "
            f"{wrong.sum(1).tolist()}, worst {float(np.nanmax(err)):.1f} px)")

        # Calibration through the CLI's helper, then the profiler's count.
        aligned = np.stack([np.arange(F)] * C, 1)
        all_uvs = video._assemble_aligned([m[0] for m in main], [m[1] for m in main], aligned)
        img_sizes = [tuple(m[2]) for m in main]
        cfg = PipelineConfig()
        names = [f"cam{c}" for c in range(C)]
        out_json = os.path.join(tmp, "calib.json")
        solves = []
        lm_solve = bundle_adjustment.lm_solve

        def recording_lm_solve(*args, **kwargs):
            out = lm_solve(*args, **kwargs)
            solves.append((args[:5], args[5], out[2]))
            return out

        def calibrate_once():
            solves.clear()
            with contextlib.redirect_stdout(io.StringIO()):
                return cli._calibrate_from_detections(all_uvs, img_sizes, cfg, names, out_json,
                                                      "json", False, dev)

        def expected(info):
            objp = torch.as_tensor(rig.calib_objpoints, device=dev)
            eb = ec = 0
            for k, (_, o, sinfo) in enumerate(solves):
                if lm_core._cuda_block_build(o, torch.float64, objp):
                    eb += sinfo["n_iters"]
                if lm_core._cuda_cost_eval(o, torch.float64, objp):
                    ec += sinfo["nfev"] + int(k == 0 and "n_poses_repaired" in info)
            return eb, ec

        real_calibrate = initialize.calibrate
        start = {}

        def recording_calibrate(*args, **kwargs):
            start["out"] = real_calibrate(*args, **kwargs)
            return start["out"]

        bundle_adjustment.lm_solve = recording_lm_solve
        initialize.calibrate = recording_calibrate
        try:
            metrics.stage_times.clear()
            (ext, intr, poses, use_frames, med, info), t_cal = timed(torch, calibrate_once)
            stages = stage_text(metrics.stage_times, 1)
            counts = (corner_main, launched("ba_blocks_kernel"),
                      launched("ba_cost_kernel"))
            check(all(n > 0 for n in counts), f"main path kernel launches {counts} "
                  "(corner, blocks, cost): a kernel of the path did not run")
            check(counts[1:] == expected(info), f"BA wrapper calls {counts[1:]}, the solves "
                  f"account for {expected(info)}")
            # Both BA kernels against their twins at this path's first
            # kernel-route solve's start (outliers deep in soft-L1's robust
            # branch among its observations).
            objp = torch.as_tensor(rig.calib_objpoints, device=dev)
            held = hold_kernels_at(torch, *next(
                (start, o) for start, o, _ in solves
                if lm_core._cuda_block_build(o, torch.float64, objp)), errs)
            # Under the profiler, the path after calibrate from the same start.
            initialize.calibrate = lambda *args, **kwargs: start["out"]
            (out_p, t_prof), prof = profiled(torch, lambda: timed(torch, calibrate_once),
                                             "20 calibration")
            device_events = [e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and not is_annotation(e)]
            busy = sum(e.time_range.elapsed_us() for e in device_events) / 1e6 / t_prof
            kernels = [re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name)
                       for e in device_events]
            nk = (kernels.count("ba_blocks_kernel"), kernels.count("ba_cost_kernel"))
            check(nk == expected(out_p[5]), f"profiler: BA kernel launches {nk}, the solves "
                  f"account for {expected(out_p[5])}")
        finally:
            bundle_adjustment.lm_solve = lm_solve
            initialize.calibrate = real_calibrate
        ext = np.asarray(ext)
        pred = mct.predict_calib_uvs(ext, intr, rig.calib_objpoints, poses,
                                     device=dev).cpu().numpy()
        err = np.linalg.norm(all_uvs[:, use_frames] - pred, axis=-1)
        rmse = float(np.sqrt(np.nanmean(err ** 2)))
        rot, trans = relative_pose_errors(ext, rig.all_extrinsics)
        log("20 calibration", f"bundle_adjust's {len(use_frames)} frames; "
            f"calibrate -> bundle_adjust -> compute_residual_metric -> save_calibration in "
            f"{t_cal:.3f} s ({stages}); n_iters {int(info['n_iters'])} nfev "
            f"{int(info['nfev'])}; kernel "
            f"launches on the path: corner {counts[0]}, ba_blocks_kernel {counts[1]}, "
            f"ba_cost_kernel {counts[2]} (profiler, from calibrate's result: {nk[0]}, {nk[1]}; "
            f"device busy {busy:.4f} of that call's {t_prof:.3f} s, {len(device_events)} "
            f"device events); "
            f"kernels vs twins at the first kernel-route solve's start, {held}; "
            f"reprojection RMSE {rmse:.4f} px; residual medians "
            + ", ".join(f"{m:.4f}" for m in med) + " mm; camera poses relative to camera 0 "
            "vs truth: rotation " + ", ".join(f"{r:.2e}" for r in rot) + " rad, translation "
            + ", ".join(f"{t:.3f}" for t in trans) + " mm")
        check(rmse < VIDEO_RMSE_PX, f"reprojection RMSE {rmse:.4f} px")
        check(bool(np.all(med < VIDEO_MEDIAN_MM)), f"residual medians {med}")
        check(max(rot) < VIDEO_ROT_RAD and max(trans) < VIDEO_TRANS_MM,
              "camera poses relative to camera 0 off the truth")

        # I/O round trips, compared as transforms (an axis-angle vector and
        # its canonical form, |r| <= pi, are the same rotation), K and dist.
        def io_diff(loaded):
            l_ext, l_intr = loaded[:2]
            return max(float(np.abs(transforms(l_ext) - transforms(ext)).max()),
                       max(float(np.abs(np.asarray(a[0]) - b[0]).max()) for a, b in zip(l_intr, intr)),
                       max(float(np.abs(np.ravel(a[1]) - np.ravel(b[1])).max())
                           for a, b in zip(l_intr, intr)))

        loaded = mct.load_calibration(out_json)
        check(loaded[2] == names, f"names {loaded[2]}")
        io_err = {"json": io_diff(loaded)}
        mct.save_calibration(ext, intr, names, os.path.join(tmp, "jarvis"), "jarvis")
        io_err["jarvis"] = io_diff(mct.load_calibration(os.path.join(tmp, "jarvis"), "jarvis"))
        try:
            import h5py  # noqa: F401
            have_h5py = True
        except ImportError:
            have_h5py = False
        gimbal = os.path.join(tmp, "calib")
        if have_h5py:
            mct.save_calibration(ext, intr, names, gimbal, "gimbal")
            io_err["gimbal"] = io_diff(mct.load_calibration(gimbal + ".h5", "gimbal"))
            gimbal_text = f"h5py present: GIMBAL {io_err['gimbal']:.1e}"
        else:
            try:
                mct.save_calibration(ext, intr, names, gimbal, "gimbal")
                raise AssertionError("GIMBAL saved without h5py")
            except ImportError as e:
                check("h5py" in str(e), f"GIMBAL's ImportError does not name h5py: {e}")
                gimbal_text = f"GIMBAL raises ImportError: {e}"
        log("20 I/O", f"JSON round trip max |diff| {io_err['json']:.1e} (transform, K, dist); "
            f"JARVIS {io_err['jarvis']:.1e}; {gimbal_text}")
        check(all(v <= IO_ATOL for v in io_err.values()), f"round trips off by {io_err}")

        # The CLI: benchmark, export, calibrate.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(CLI_BENCH)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rec["platform"] == "gpu"
              and rec["final_cost"] <= CLI_BENCH_JAX_COST * (1 + BA_COST_RTOL),
              f"mcc benchmark: {rec}; the JAX package's final cost {CLI_BENCH_JAX_COST}")
        back = os.path.join(tmp, "back.json")
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["export", out_json, os.path.join(tmp, "cli_jarvis"), "--from-format",
                            "json", "--to-format", "jarvis"]) == 0, "export json -> jarvis")
            check(cli.main(["export", os.path.join(tmp, "cli_jarvis"), back, "--from-format",
                            "jarvis", "--to-format", "json"]) == 0, "export jarvis -> json")
        io_err["export"] = io_diff(mct.load_calibration(back))
        check(io_err["export"] <= IO_ATOL, f"export round trip off by {io_err['export']:.1e}")
        if have_h5py:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["calibrate", *paths, "--output", os.path.join(tmp, "cli.json")])
            check(rc == 0, "mcc calibrate")
            calibrate_text = "calibrate ran (h5py present)"
        else:
            try:
                cli.main(["calibrate", *paths, "--output", os.path.join(tmp, "cli.json")])
                raise AssertionError("mcc calibrate ran without h5py")
            except ImportError as e:
                check("h5py" in str(e), f"calibrate's ImportError does not name h5py: {e}")
                calibrate_text = f"calibrate raises ImportError: {e}"
        log("20 CLI", f"benchmark {json.dumps(rec)}; export json -> jarvis -> json max |diff| "
            f"{io_err['export']:.1e}; "
            + calibrate_text)
        kept = [shutil.copy(p, keep_dir) for p in paths[:SHARD_VIDEOS]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("20 phase", f"{time.perf_counter() - t_phase:.1f} s")
    return kept


# Phase 21: the frame-sharded solve (parallel/). 21a: BASELINE.json config 5's
# shape (a 64-camera volumetric stage, 20,000 frames, distributed Schur BA),
# started from the truth perturbed as tests/test_scale_64cam.py does (at this
# size calibrate would take the phase), world size 1 over NCCL. 21b-21d: two
# ranks on the one card. NCCL refuses two ranks on one device, so these are
# two spawned processes on cuda:0 over gloo, which stages their all-reduces
# through the host; each rank's kernels run on the card.
SHARD_BIG = dict(n_cameras=64, n_frames=20000, noise_px=NOISE_PX, dropout=0.25, seed=11)
SHARD_START_SD, SHARD_START_SEED = 1e-3, 1  # tests/test_scale_64cam.py:29-31
SHARD_RTOL_ONE = 2e-6  # __graft_entry__.py:93-115, the sharded solve's certificate
# JAX's kernel-route tolerance for a sharded solve (tests/test_ba_pallas.py:
# 424-432) over the first iterations, held against lm_solve over the same
# frame slabs (frame_chunk = a rank's frames). Against the dense lm_solve the
# f32 recipe's sum order alone moves the bench problem's costs by ~1e-4 (a
# one-process solve with two slabs does too), so that difference is printed.
SHARD_RTOL_RANKS, SHARD_RANK_ITERS = 5e-5, 3
SHARD_RANKS, SHARD_FRAMES = 2, (922, 921)  # 461 + 461; 461 + 460 and a padded frame
SHARD_VIDEOS, SHARD_VIDEO_FRAMES = 2, 128
SHARD_TRI_RTOL = 1e-10
SHARD_TIMEOUT_S = 180  # a rank waiting on a dead peer raises after this


def collective_bytes(C, nfev, n_iters):
    """(all-reduces, bytes) that lm_solve's psum points take on the f32
    recipe with f64 data: the first cost; per try the cost, U and g_cam
    (f64), S_cross and rhs_cross (f32, the solve dtype); per iteration g_cam
    and the sums of g_pose^2 and of the pose steps squared (f64)."""
    tries = nfev - 1
    per_try = 8 + 8 * (144 * C + 12 * C) + 4 * ((12 * C) ** 2 + 12 * C)
    return 1 + 5 * tries + 3 * n_iters, 8 + tries * per_try + n_iters * (96 * C + 16)


def precision_flags(torch):
    return " ".join(map(str, (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32,
                              torch.get_float32_matmul_precision())))


def detect_without_cache(video_paths, detection_fun=None, detection_options=None,
                         aligned_frame_ixs=None, device=None, **_):
    """``run_calibration_detection`` without its HDF5 cache (this host may
    have no h5py, and a cache would hand the second call the first one's
    answer): ``_detect_video`` on each video's aligned frames, then
    ``_assemble_aligned``, as that function does."""
    from multicam_calibration_tpu_torch.detection import video

    uvs, ixs, sizes = [], [], []
    for i, path in enumerate(video_paths):
        use = aligned_frame_ixs[:, i]
        u, f, size, _ = video._detect_video(path, detection_fun, detection_options,
                                            use[~np.isnan(use)].astype(int), device=device)
        uvs.append(u)
        ixs.append(f)
        sizes.append(tuple(size))
    return video._assemble_aligned(uvs, ixs, aligned_frame_ixs), sizes


def shard_rank(rank, port, outdir, videos):
    """One of phase 21's two ranks on cuda:0 (gloo): 21b's sharded solves
    and bundle_adjust on the mesh, 21c's sharded_triangulate, 21d's
    distributed_calibration_detection; kernel launches counted from 0 just
    before each path and read just after. Writes rank{rank}.npz."""
    import datetime

    import torch
    import torch.distributed as dist

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.detection import video
    from multicam_calibration_tpu_torch.device import cuda_device
    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.parallel import (
        collectives, distributed_calibration_detection, make_frame_mesh, sharded_lm_solve,
        sharded_triangulate)
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    # A rank that forgets the numerics contract: TF32 on; the port pins it
    # off inside every call.
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    flags = set()
    solve = lm_core._equilibrated_solve

    def recording_solve(M, b):
        flags.add(precision_flags(torch))
        return solve(M, b)

    lm_core._equilibrated_solve = recording_solve
    out = {}

    def zero():
        zero_launches("ba_blocks_kernel", "ba_cost_kernel", "corner_peaks_kernel")
        collectives.all_reduce.calls = collectives.all_reduce.bytes = 0

    def launches():
        return [launched("ba_blocks_kernel"), launched("ba_cost_kernel"),
                launched("corner_peaks_kernel"), collectives.all_reduce.calls,
                collectives.all_reduce.bytes]

    try:
        dev = cuda_device()
        mesh = make_frame_mesh(device=dev)
        cam0, poses0, obs, mask, objp = bench_problem(torch, dev)
        opts = lm_options_from_jax(BENCH_JAX_OPTIONS)
        sharded_lm_solve(cam0, poses0, obs, mask, objp, dataclasses.replace(opts, max_iters=1),
                         mesh=mesh)  # warm-up: the process's first solve
        for F in SHARD_FRAMES:
            zero()
            (cam, poses, info), wall = timed(torch, lambda: sharded_lm_solve(
                cam0, poses0[:F], obs[:, :F], mask[:, :F], objp, opts, mesh=mesh))
            out.update({f"f{F}_cam": cam.cpu().numpy(), f"f{F}_poses": poses.cpu().numpy(),
                        f"f{F}_history": info["history"].cpu().numpy(),
                        f"f{F}_info": np.array([info["n_iters"], info["nfev"],
                                                info["final_cost"], wall]),
                        f"f{F}_counts": np.array(launches())})

        # bundle_adjust on the mesh from JAX's calibrate outputs (phase 11's start).
        ref = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
        rig = mct.make_synthetic_rig(**RIG)
        metrics.configure(os.path.join(outdir, f"metrics{rank}.jsonl"))
        zero()
        (_, _, _, uf, info), wall = timed(torch, lambda: mct.bundle_adjust(
            rig.all_calib_uvs, ref["ext"], list(zip(ref["K"], ref["dist"])),
            rig.calib_objpoints, ref["poses"], verbose=False, device=dev, mesh=mesh))
        metrics.configure(None)
        out.update(ba_uf=uf, ba_info=np.array([float(info["final_cost"]), int(info["n_iters"]),
                                               wall]), ba_counts=np.array(launches()))

        # 21c at two ranks, held against the port's triangulate in this process.
        views, _ = big_triangulation_views(torch, dev, rig)
        cams = (list(rig.all_extrinsics), rig.all_intrinsics)
        points = make_frame_mesh(axis_name="points", device=dev)
        sharded_triangulate(views, *cams, mesh=points, return_sd=True, device=dev)  # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        (pts, sd), wall = timed(torch, lambda: sharded_triangulate(
            views, *cams, mesh=points, return_sd=True, device=dev))
        peak = torch.cuda.max_memory_allocated(dev)
        ref_pts, ref_sd = mct.triangulate(views, *cams, return_sd=True, device=dev)
        worst = [close_to(a.cpu().numpy(), b.cpu().numpy(), SHARD_TRI_RTOL, 0.0,
                          f"rank {rank} sharded_triangulate {k}")
                 for a, b, k in ((pts, ref_pts, "points"), (sd, ref_sd, "sd"))]
        out["tri"] = np.array([*worst, wall, peak, int(torch.isfinite(pts).all(-1).sum())])
        del views, pts, sd, ref_pts, ref_sd

        # 21d: each rank detects its video's first frames; rank 0 then holds
        # the result against both videos detected in this one process.
        video.run_calibration_detection = detect_without_cache
        aligned = np.stack([np.arange(SHARD_VIDEO_FRAMES)] * len(videos), axis=1).astype(float)
        zero()
        (uvs, sizes), wall = timed(torch, lambda: distributed_calibration_detection(
            videos, None, {"board_shape": VIDEO_BOARD}, aligned_frame_ixs=aligned, device=dev))
        out.update(dcd_uvs=uvs, dcd_sizes=np.asarray(sizes), dcd_counts=np.array(launches()),
                   dcd_wall=np.array(wall))
        if rank == 0:
            ref_uvs, ref_sizes = detect_without_cache(
                videos, video.detect_chessboard, {"board_shape": VIDEO_BOARD}, aligned,
                device=dev)
            out["dcd_equal"] = np.array(np.array_equal(uvs, ref_uvs, equal_nan=True)
                                        and list(map(tuple, sizes)) == ref_sizes)
        out["flags"] = np.array(sorted(flags))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_ranks(outdir, videos):
    """Phase 21's two ranks, spawned together; raises unless both exit 0
    within the deadline (a straggler is killed)."""
    import multiprocessing
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, port, outdir, videos))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 4 * SHARD_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * SHARD_RANKS, f"phase 21 ranks exited {codes}")
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(SHARD_RANKS)]


def sharded_phase(torch, dev, bench_rig, videos):
    """Phase 21: sharded_lm_solve at BASELINE config 5's shape (world size 1,
    NCCL) against lm_solve; sharded_triangulate at phase 17's size; then two
    gloo ranks on the card (run_ranks)."""
    from types import SimpleNamespace

    import torch.distributed as dist

    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.convert import lm_options_from_jax
    from multicam_calibration_tpu_torch.models import lm_core
    from multicam_calibration_tpu_torch.models.bundle_adjustment import _params_to_arrays
    from multicam_calibration_tpu_torch.parallel import (
        collectives, make_frame_mesh, sharded_lm_solve, sharded_triangulate)

    t_phase = time.perf_counter()
    rig, t_rig = timed(torch, lambda: mct.make_synthetic_rig(**SHARD_BIG))
    full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    obs_np = rig.all_calib_uvs[:, use]
    ext = rig.all_extrinsics + np.random.default_rng(SHARD_START_SEED).normal(
        0, SHARD_START_SD, rig.all_extrinsics.shape)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    cam0, poses0 = as_t(_params_to_arrays(ext, rig.all_intrinsics)), as_t(rig.calib_poses[use])
    obs, mask = as_t(np.nan_to_num(obs_np)), as_t(~np.isnan(obs_np).any(-1))
    objp = as_t(rig.calib_objpoints)
    del obs_np, rig
    C, F, N = mask.shape
    opts = dataclasses.replace(lm_options_from_jax(BENCH_JAX_OPTIONS), frame_chunk=CHUNK)
    check(lm_core._cuda_block_build(opts, torch.float64, objp)
          and lm_core._cuda_cost_eval(opts, torch.float64, objp),
          f"the recipe does not reach both kernels: {opts}")
    mesh = make_frame_mesh(device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == backend and mesh.size() == 1,
          f"{dist.get_backend()} group of {mesh.size()}")
    sharded = lambda: sharded_lm_solve(cam0, poses0, obs, mask, objp, opts, mesh=mesh)  # noqa: E731
    single = lambda: lm_core.lm_solve(cam0, poses0, obs, mask, objp, opts)  # noqa: E731

    def run(fn):
        zero_launches("ba_blocks_kernel", "ba_cost_kernel")
        collectives.all_reduce.calls = collectives.all_reduce.bytes = 0
        collectives.all_gather.calls = collectives.all_gather.bytes = 0
        torch.cuda.reset_peak_memory_stats(dev)
        (cam, poses, info), wall = timed(torch, fn)
        return SimpleNamespace(
            cam=cam, poses=poses, info=info, wall=wall, nb=launched("ba_blocks_kernel"),
            nc=launched("ba_cost_kernel"), ar=(collectives.all_reduce.calls,
                                                  collectives.all_reduce.bytes),
            ag=(collectives.all_gather.calls, collectives.all_gather.bytes),
            peak=torch.cuda.max_memory_allocated(dev))

    warm = run(lambda: sharded_lm_solve(cam0, poses0, obs, mask, objp,
                                        dataclasses.replace(opts, max_iters=2), mesh=mesh))
    main = run(sharded)  # the main path: counts from 0, read just after
    check(main.nb > 0 and main.nc > 0, "the sharded solve did not launch both BA kernels")
    one = run(single)
    # Two more walls each, in turns: sharded, single, single, sharded.
    walls = {"sharded": [main.wall], "single": [one.wall]}
    for label, fn in (("single", single), ("sharded", sharded)):
        walls[label].append(run(fn).wall)
    n = main.info["n_iters"]
    nc_slabs = lm_core._chunking(opts, F)[2]
    check(main.nb == n * nc_slabs and main.nc == main.info["nfev"],
          f"block calls {main.nb}, cost calls {main.nc}; n_iters {n} x {nc_slabs} slabs, "
          f"nfev {main.info['nfev']}")
    check(n == one.info["n_iters"], f"n_iters {n} vs lm_solve's {one.info['n_iters']}")
    h_main = main.info["history"][:n, 0].cpu().numpy()
    h_one = one.info["history"][:n, 0].cpu().numpy()
    traj = float(np.max(np.abs(h_main - h_one) / np.abs(h_one)))
    check(traj <= SHARD_RTOL_ONE, f"cost trajectory off lm_solve's by {traj:.3e}")
    bit_equal = (torch.equal(main.info["history"], one.info["history"])
                 and torch.equal(main.cam, one.cam) and torch.equal(main.poses, one.poses))
    n_obs = int(mask.sum())
    floor_cost = 2 * n_obs * 0.5 * NOISE_PX**2 * (1 - 0.75 * NOISE_PX**2)
    cost = main.info["final_cost"]
    check(cost <= 1.05 * floor_cost, f"final cost {cost:.1f} above 1.05 x the noise floor "
          f"{floor_cost:.1f} of its {n_obs} observations")
    expected = collective_bytes(C, main.info["nfev"], n)
    check(main.ar == expected, f"all-reduces (calls, bytes) {main.ar}, lm_solve's psum points "
          f"account for {expected}")
    per_try = collective_bytes(C, 2, 0)[1] - 8

    def all_reduce_ms(x, reps=20):
        """Host ms of one all-reduce of x over the mesh: reps in a row after
        a warm-up, synchronised at the end."""
        collectives.all_reduce(x, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            collectives.all_reduce(x, mesh)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    ar_ms = (all_reduce_ms(torch.zeros((), dtype=torch.float64, device=dev)),
             all_reduce_ms(torch.zeros((C, 12, C, 12), device=dev)))

    # The profiler: kernel launches and the device's busy share of a solve.
    r, prof = profiled(torch, lambda: run(sharded), "21a sharded solve")
    c10d_ms = sum(a.cpu_time_total for a in prof.key_averages()
                  if a.key.startswith("c10d::")) / 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name) for e in events]
    events = [e for e in events if not is_annotation(e)]
    nk = (names.count("ba_blocks_kernel"), names.count("ba_cost_kernel"))
    check(nk == (r.nb, r.nc), f"profiler: kernel launches {nk}, wrapper calls {r.nb}, {r.nc}")
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    log("21a sharded solve", f"BASELINE config 5's shape: {C} cameras x {F} frames (of "
        f"{SHARD_BIG['n_frames']}, those >= 2 cameras see) x {N} points, {n_obs} observations, "
        f"from the truth + N(0, {SHARD_START_SD:g}) extrinsics, rig made in {t_rig:.2f} s; "
        f"bench options + frame_chunk={CHUNK} ({nc_slabs} slabs), world size 1 over {backend}: "
        f"sharded_lm_solve walls " + ", ".join(f"{w:.4f}" for w in walls["sharded"])
        + f" s (warm-up {warm.wall:.4f} s), lm_solve " + ", ".join(
            f"{w:.4f}" for w in walls["single"]) + f" s (in turns: sharded, single, single, "
        f"sharded); n_iters {n}, nfev {main.info['nfev']}; cost "
        f"{main.info['initial_cost']:.1f} -> {cost:.1f} = {cost / floor_cost:.4f} x the noise "
        f"floor {floor_cost:.1f}; trajectory vs lm_solve max rel diff {traj:.3e} (bit-equal: "
        f"{bit_equal}); all-reduces {main.ar[0]} ({main.ar[1]} B) = 1 + 5 per try + 3 per "
        f"iteration, {per_try} B a try (S_cross {4 * (12 * C) ** 2} B), all-gathers "
        f"{main.ag[0]} ({main.ag[1]} B); one all-reduce {ar_ms[0]:.4f} ms (cost) / {ar_ms[1]:.4f} "
        f"ms (S_cross) of host time, c10d ops {c10d_ms:.1f} ms of the profiled solve's host "
        f"time; block / cost calls {main.nb} / {main.nc}, profiler "
        f"{nk[0]} / {nk[1]}; profiled solve {r.wall:.4f} s, device busy {busy:.1f} ms "
        f"({busy / (1e3 * r.wall):.1%}), {len(events)} device ops; peak device memory "
        f"{main.peak / 2**30:.3f} GiB (lm_solve {one.peak / 2**30:.3f})")
    del obs, mask, main, one, r, prof, events

    # 21c at world size 1: phase 17's size.
    views, _ = big_triangulation_views(torch, dev, bench_rig)
    cams = (list(bench_rig.all_extrinsics), bench_rig.all_intrinsics)
    points = make_frame_mesh(axis_name="points", device=dev)
    sharded_triangulate(views, *cams, mesh=points, return_sd=True, device=dev)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    (pts, sd), wall = timed(torch, lambda: sharded_triangulate(views, *cams, mesh=points,
                                                              return_sd=True, device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    ref_pts, ref_sd = mct.triangulate(views, *cams, return_sd=True, device=dev)
    worst = [close_to(a.cpu().numpy(), b.cpu().numpy(), SHARD_TRI_RTOL, 0.0, k)
             for a, b, k in ((pts, ref_pts, "sharded points"), (sd, ref_sd, "sharded sd"))]
    tri_one = (worst, wall, peak)
    del views, pts, sd, ref_pts, ref_sd
    dist.destroy_process_group()

    # 21b-21d: two ranks on the card; the single-rank solves they are held to.
    cam_b, poses_b, obs_b, mask_b, objp_b = bench_problem(torch, dev)
    bench_opts = lm_options_from_jax(BENCH_JAX_OPTIONS)
    ref = {(f, chunk): lm_core.lm_solve(
        cam_b, poses_b[:f], obs_b[:, :f], mask_b[:, :f], objp_b,
        dataclasses.replace(bench_opts, frame_chunk=chunk))[2]
        for f in SHARD_FRAMES for chunk in (None, -(-f // SHARD_RANKS))}
    del cam_b, poses_b, obs_b, mask_b, objp_b
    torch.cuda.empty_cache()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ranks, t_ranks = timed(torch, lambda: run_ranks(outdir, videos))
        skips = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(outdir, f"metrics{r}.jsonl")) as f:
                skips.append(sum(json.loads(ln)["event"] == "ba_pose_repair_skipped"
                                 for ln in f))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    r0 = ranks[0]
    for r, rr in enumerate(ranks):
        check(rr["flags"].tolist() == ["False False highest"],
              f"rank {r} solved with TF32 / precision {rr['flags'].tolist()}")
        for k in ("f922_cam", "f922_history", "f921_cam", "f921_history", "ba_uf",
                  "dcd_uvs", "dcd_sizes"):
            check(np.array_equal(rr[k], r0[k], equal_nan=True), f"rank {r} differs in {k}")
        for F in SHARD_FRAMES:
            check(np.array_equal(rr[f"f{F}_info"][:2], r0[f"f{F}_info"][:2]),
                  f"rank {r}: n_iters, nfev {rr[f'f{F}_info'][:2]} vs rank 0's")
            check(rr[f"f{F}_counts"][0] > 0 and rr[f"f{F}_counts"][1] > 0,
                  f"rank {r}, {F} frames: BA kernels not launched {rr[f'f{F}_counts']}")
        check(rr["ba_counts"][0] > 0 and rr["ba_counts"][1] > 0,
              f"rank {r}: bundle_adjust did not launch both BA kernels")
        check(rr["dcd_counts"][2] > 0, f"rank {r}: the corner kernel was not launched")
        check(skips[r] >= 1, f"rank {r}: pose repair not logged as skipped")
    rows = []

    def traj(a, b):
        k = min(SHARD_RANK_ITERS, len(a), len(b))
        return float(np.max(np.abs(a[:k] - b[:k]) / np.abs(b[:k])))

    for F in SHARD_FRAMES:
        info = r0[f"f{F}_info"]
        slabs, dense = ref[F, -(-F // SHARD_RANKS)], ref[F, None]
        costs = {k: v["history"][:v["n_iters"], 0].cpu().numpy() for k, v in
                 (("slabs", slabs), ("dense", dense))}
        got = r0[f"f{F}_history"][:int(info[0]), 0]
        rel = traj(got, costs["slabs"])
        check(rel <= SHARD_RTOL_RANKS, f"{F} frames: cost trajectory off lm_solve's over the "
              f"same slabs by {rel:.3e}")
        check(info[2] <= SCIPY_TRF_COST, f"{F} frames: final cost {info[2]} above "
              f"{SCIPY_TRF_COST}")
        counts = [rr[f"f{F}_counts"] for rr in ranks]
        rows.append(f"{F} frames ({' + '.join(str(-(-F // SHARD_RANKS)) for _ in ranks)}"
                    f"{', one padded' if F % SHARD_RANKS else ''}): n_iters {int(info[0])} nfev "
                    f"{int(info[1])}, final cost {info[2]:.4f}; lm_solve over the same slabs "
                    f"{slabs['n_iters']} / {slabs['nfev']}, {slabs['final_cost']:.4f}, first "
                    f"{SHARD_RANK_ITERS} iterations' costs max rel diff {rel:.2e}; dense "
                    f"lm_solve {dense['n_iters']} / {dense['nfev']}, {dense['final_cost']:.4f}, "
                    f"max rel diff {traj(got, costs['dense']):.2e} (dense vs slabs in one "
                    f"process {traj(costs['slabs'], costs['dense']):.2e}); walls "
                    + ", ".join(f"{rr[f'f{F}_info'][3]:.4f}" for rr in ranks)
                    + " s; per rank block / cost calls, all-reduces (bytes) "
                    + ", ".join(f"{c[0]} / {c[1]}, {c[3]} ({c[4]})" for c in counts))
    bench_ref = np.load(os.path.join(DATA, "bench_ba_ref.npz"))
    check(np.array_equal(r0["ba_uf"], bench_ref["use_frames"]),
          "bundle_adjust on the mesh: use_frames differ from phase 11's (JAX's)")
    ba_cost = float(r0["ba_info"][0])
    check(ba_cost <= float(bench_ref["final_cost"]) * (1 + BA_COST_RTOL),
          f"bundle_adjust on the mesh: final cost {ba_cost} above JAX's "
          f"{float(bench_ref['final_cost'])} x (1 + {BA_COST_RTOL:g})")
    check(bool(r0["dcd_equal"]), "distributed_calibration_detection differs from one process")
    log("21b two ranks", f"gloo on one {dev.type} device, bench problem, bench options: "
        + "; ".join(rows) + f"; ranks bit-identical in n_iters, nfev, history, cameras; TF32 "
        f"off inside each rank's solves; bundle_adjust(mesh=...) from JAX's start: "
        f"{len(r0['ba_uf'])} frames as phase 11's, final cost {ba_cost:.4f} (JAX "
        f"{float(bench_ref['final_cost']):.4f}), n_iters {int(r0['ba_info'][1])}, walls "
        + ", ".join(f"{rr['ba_info'][2]:.4f}" for rr in ranks) + " s, block / cost calls "
        + ", ".join(f"{rr['ba_counts'][0]} / {rr['ba_counts'][1]}" for rr in ranks)
        + f", pose repair skipped (logged {skips})")
    log("21c sharded_triangulate", f"{len(bench_rig.all_extrinsics)} x {TRI_BIG['n_points']} "
        f"points (phase 17's), return_sd: world size 1 ({backend}) wall {tri_one[1]:.4f} s, peak "
        f"{tri_one[2] / 2**30:.3f} GiB, within {SHARD_TRI_RTOL:g} of triangulate (worst "
        f"err/tol {max(tri_one[0]):.2e}), NaN alike; two ranks (gloo): walls "
        + ", ".join(f"{rr['tri'][2]:.4f}" for rr in ranks) + " s, peaks "
        + ", ".join(f"{rr['tri'][3] / 2**30:.3f}" for rr in ranks) + " GiB, worst err/tol "
        + ", ".join(f"{max(rr['tri'][:2]):.2e}" for rr in ranks) + f", {int(r0['tri'][4])} "
        "finite points")
    log("21d distributed detection", f"{len(videos)} of phase 20's videos, first "
        f"{SHARD_VIDEO_FRAMES} frames, one per rank: bit-equal to both detected in one process "
        f"({int(np.isfinite(r0['dcd_uvs']).all((-1, -2)).sum())} detections, image sizes "
        f"{r0['dcd_sizes'].tolist()}); walls " + ", ".join(f"{float(rr['dcd_wall']):.2f}"
                                                          for rr in ranks)
        + " s; corner launches per rank " + ", ".join(str(rr["dcd_counts"][2]) for rr in ranks)
        + f"; ranks' process wall {t_ranks:.1f} s")
    log("21 phase", f"{time.perf_counter() - t_phase:.1f} s")


# Phase 22: the camera-batched intrinsics stage. BASELINE.json config 5's 64
# cameras at config 3's 2,000 frames: config 5's 20,000 frames are cut to
# 2,000, because the intrinsics sample only INTR_SAMPLES frames per camera
# and phase 21a already runs 20,000 (the rest feeds calibrate's poses,
# extrinsics and consensus).
INTR_RIG = dict(n_cameras=64, n_frames=2000, noise_px=NOISE_PX, dropout=0.25, seed=11)
INTR_SAMPLES = 100  # get_intrinsics_batch's default, as the JAX package's
INTR_TIMED, CAL_TIMED = 5, 3
INTR_K_RTOL, INTR_DIST_ATOL = 1e-7, 1e-6  # tests/test_torch_initialize.py
# The final cost of the solve each camera keeps, batched vs loop, every
# camera (CPU rehearsal: <= 3.3e-9, camera 32; the others <= 4e-15).
INTR_COST_RTOL = 1e-7
# The scaling of a camera's detections that tells an unstable intrinsics
# solve (phase 10's test of JAX's planar poses), and an unstable camera's K,
# batched vs loop, within INTR_UNSTABLE_FACTOR times that move of its own.
INTR_PERTURB, INTR_UNSTABLE_FACTOR = 1e-15, 10.0
# calibrate's start against the rig's truth, each camera relative to camera 0,
# over the cameras outside unstable_cameras of (b)'s unstable ones: twice the
# largest of a CPU rehearsal of (c) (0.0652 rad, 59.32 mm, both camera 52);
# over those cameras, twice the rehearsal's camera 32 (0.1166 rad, 798.76 mm).
CAL_ROT_RAD, CAL_TRANS_MM = 0.13, 120.0
CAL_UNSTABLE_ROT_RAD, CAL_UNSTABLE_TRANS_MM = 0.24, 1600.0


def count_syncs(torch, fn):
    """(fn(), the synchronising CUDA calls fn made), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def intrinsics_rel(a, b):
    """(max relative difference of K, max absolute difference of the
    distortion) between two (K, dist) pairs."""
    return (float(np.max(np.abs(a[0] - b[0]) / np.abs(b[0]).clip(min=1e-300))),
            float(np.max(np.abs(a[1] - b[1]))))


def kept_cost(K, solves):
    """The final cost of the solve whose (fx, fy, cx, cy) a camera kept, from
    its solves' ((fx, fy, cx, cy), final cost) pairs."""
    fc = K[[0, 1, 0, 1], [0, 1, 2, 2]]
    costs = [float(cost) for cam, cost in solves
             if np.array_equal(cam.detach().cpu().numpy().reshape(-1)[:4], fc)]
    check(bool(costs), f"no solve returned the kept intrinsics {fc}")
    return costs[0]


def lockstep_tries(info):
    """The tries of a lockstep lane solve: per iteration the most any lane
    took (at least 1), from the lanes' histories."""
    n = int(info["n_iters"].max())
    return int(info["history"][:, :n, 4].max(0).values.clamp(min=1).sum())


def lane_text(info):
    """A lane solve: lockstep iterations, per-lane n_iters / nfev (min,
    median, max), converged lanes and host reads."""
    n, f = info["n_iters"].cpu().numpy(), info["nfev"].cpu().numpy()
    mmm = lambda a: f"{a.min()} / {np.median(a):g} / {a.max()}"  # noqa: E731
    return (f"{int(n.max())} lockstep iterations, {lockstep_tries(info)} tries; per lane "
            f"n_iters {mmm(n)}, nfev {mmm(f)} (min / median / max), converged "
            f"{int(info['converged'].sum())} of {len(n)}; host reads {info['host_reads']}")


def intrinsics_phase(torch, dev):
    """Phase 22: get_intrinsics_batch (one lockstep LM over the cameras)
    against the per-camera loop, and calibrate on its batched route, at 64
    cameras x 2,000 frames."""
    import multicam_calibration_tpu_torch as mct
    from multicam_calibration_tpu_torch.models import initialize
    from multicam_calibration_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    rig, t_rig = timed(torch, lambda: mct.make_synthetic_rig(**INTR_RIG))
    C = INTR_RIG["n_cameras"]
    full = (~np.isnan(rig.all_calib_uvs).any((-1, -2))).sum(1)
    args = (rig.all_calib_uvs, rig.calib_objpoints, rig.img_sizes)
    solves, flags = [], []
    real = (initialize._lm_solve_lanes, initialize._basin_guard)

    def lanes(*a, **kw):
        out = real[0](*a, **kw)
        solves.append((out[0], out[2]))
        return out

    def guard(*a):
        flags.append(real[1](*a))
        return flags[-1]

    def batch():
        solves.clear()
        flags.clear()
        return initialize.get_intrinsics_batch(*args, n_samples=INTR_SAMPLES, device=dev)

    initialize._lm_solve_lanes, initialize._basin_guard = lanes, guard
    try:
        intr, warm = timed(torch, batch)
        walls = []
        for _ in range(INTR_TIMED):
            again, wall = timed(torch, batch)
            walls.append(wall)
            check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                      for a, b in zip(again, intr)), "get_intrinsics_batch is not deterministic")
        batch_solves, flagged = list(solves), flags[-1]
        infos = [info for _, info in batch_solves]
        # Device activity only: a call's CPU-side ops number ~10x its kernels.
        (_, busy_wall), prof = profiled(torch, lambda: timed(torch, batch), "22a intrinsics",
                                        cpu=False)
        _, syncs = count_syncs(torch, batch)
    finally:
        initialize._lm_solve_lanes, initialize._basin_guard = real
    check(len(infos) == 1 + bool(flagged.any()), f"{len(infos)} lane solves, "
          f"{int(flagged.sum())} flagged cameras")
    for info in infos:
        check(info["host_reads"] == lockstep_tries(info), f"host reads {info['host_reads']}, "
              f"lockstep tries {lockstep_tries(info)}")
        check(info["host_reads"] < int(info["nfev"].sum()) - C,
              "the lane solve reads as often as the cameras try")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not is_annotation(e)]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    reads = sum(info["host_reads"] for info in infos)
    log("22a intrinsics batch", f"{C} cameras x {INTR_RIG['n_frames']} frames (rig made in "
        f"{t_rig:.2f} s; {full.min()}-{full.max()} fully detected frames per camera), "
        f"{INTR_SAMPLES} samples per camera: wall " + walls_text(walls)
        + f", warm-up {warm:.4f} s; {int(flagged.sum())} cameras flagged by the basin guard "
        f"{np.nonzero(flagged)[0].tolist()}; " + "; ".join(
            f"solve {k + 1}: " + lane_text(info) for k, info in enumerate(infos))
        + f"; host reads per call {reads} (one per lockstep try), synchronising calls per call "
        f"{syncs} (sync debug mode); profiled call {busy_wall:.4f} s, device busy {busy:.1f} ms "
        f"({busy / (1e3 * busy_wall):.1%}), {len(events)} device ops; "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # (b) the per-camera loop, once, with the (fx, fy, cx, cy) and final cost
    # of every solve it makes.
    loop_solves = []
    real_solve = initialize.lm_solve

    def solve(*a, **kw):
        out = real_solve(*a, **kw)
        loop_solves[-1].append((out[0][0, :4], out[2]["final_cost"]))
        return out

    def per_camera(scale=1.0, cameras=range(C)):
        out = []
        for c in cameras:
            loop_solves.append([])
            out.append(initialize.get_intrinsics(
                rig.all_calib_uvs[c] * scale, rig.calib_objpoints, rig.img_sizes[c],
                n_samples=INTR_SAMPLES, device=dev))
        return out

    batch_costs = [kept_cost(intr[c][0], [(cam[c, 0, :4], info["final_cost"][c])
                                          for cam, info in batch_solves]) for c in range(C)]
    unconverged = ~torch.stack([info["converged"] for info in infos]).all(0).cpu().numpy()
    initialize.lm_solve = solve
    try:
        loop, loop_wall = timed(torch, per_camera)
        loop_costs = [kept_cost(loop[c][0], loop_solves[c]) for c in range(C)]
        _, loop_syncs = count_syncs(torch, lambda: per_camera(cameras=[0]))
        k_rel = [intrinsics_rel(a, b) + (abs(cb - cl) / cl,)
                 for a, b, cb, cl in zip(intr, loop, batch_costs, loop_costs)]
        off = [c for c in range(C) if k_rel[c][0] > INTR_K_RTOL or k_rel[c][1] > INTR_DIST_ATOL
               or k_rel[c][2] > INTR_COST_RTOL]
        # A camera off a gate must be one whose own solve is unstable: its K
        # moves by more than the gate when its detections are scaled by
        # 1 +- 1e-15. Tried on those and on every camera with a lane that ran
        # unconverged. Its own moves (K, distortion, kept cost) bound it.
        moved = {}
        for c in sorted(set(off) | set(np.nonzero(unconverged)[0].tolist())):
            runs = [(per_camera(s, [c])[0], loop_solves[-1])
                    for s in (1 + INTR_PERTURB, 1 - INTR_PERTURB)]
            moved[c] = np.max([intrinsics_rel(loop[c], again)
                               + (abs(kept_cost(again[0], solved) - loop_costs[c]) / loop_costs[c],)
                               for again, solved in runs], axis=0)
    finally:
        initialize.lm_solve = real_solve
    unstable = [c for c, m in moved.items() if m[0] > INTR_K_RTOL]
    check(set(off) <= set(unstable),
          "batched vs per-camera off the gates on stable cameras: " + ", ".join(
              f"camera {c}: K rel {k_rel[c][0]:.3e}, distortion {k_rel[c][1]:.3e}, kept cost "
              f"{k_rel[c][2]:.3e}" for c in off if c not in unstable))
    wild = [c for c in unstable if any(k_rel[c][k] > max(tol, INTR_UNSTABLE_FACTOR * moved[c][k])
                                       for k, tol in enumerate((INTR_K_RTOL, INTR_DIST_ATOL,
                                                                INTR_COST_RTOL)))]
    check(not wild, "unstable cameras off their bounds: " + ", ".join(
        f"camera {c}: K, distortion, kept cost {k_rel[c]} against {INTR_UNSTABLE_FACTOR:g} x "
        f"own moves {moved[c].tolist()}" for c in wild))
    stable = [c for c in range(C) if c not in unstable]
    log("22b intrinsics loop", f"get_intrinsics camera by camera: {loop_wall:.4f} s "
        f"({loop_wall / statistics.median(walls):.1f} x the batched median); synchronising calls "
        f"of camera 0's call {loop_syncs}; batched vs loop on the {len(stable)} stable cameras: "
        f"K max rel diff {max(k_rel[c][0] for c in stable):.3e} (gate {INTR_K_RTOL:g}), "
        f"distortion max abs diff {max(k_rel[c][1] for c in stable):.3e} (gate "
        f"{INTR_DIST_ATOL:g}), final cost of the kept solve max rel diff "
        f"{max(k_rel[c][2] for c in stable):.3e} (gate {INTR_COST_RTOL:g}); unstable cameras "
        f"(their own K moves past the gate when the detections are scaled by 1 +- "
        f"{INTR_PERTURB:g}; each difference held within {INTR_UNSTABLE_FACTOR:g} x the own move): "
        + (", ".join(
            f"{c} (batched vs loop: K {k_rel[c][0]:.3e}, distortion {k_rel[c][1]:.3e}, kept cost "
            f"{batch_costs[c]:.6f} vs {loop_costs[c]:.6f}, rel {k_rel[c][2]:.3e}; own moves "
            f"{moved[c][0]:.3e}, {moved[c][1]:.3e}, {moved[c][2]:.3e}; ratios "
            + ", ".join(f"{k_rel[c][k] / max(moved[c][k], 1e-300):.2f}" for k in range(3))
            + f"; fx {intr[c][0][0, 0]:.2f} vs the rig's {rig.all_intrinsics[c][0][0, 0]:.2f})"
            for c in unstable) or "none")
        + "; own K moves of the cameras tried: " + ", ".join(
            f"{c} {m[0]:.3e}" for c, m in moved.items())
        + f"; {time.perf_counter() - t_phase:.1f} s into the phase")

    # (c) calibrate on the batched route.
    call = lambda: mct.calibrate(  # noqa: E731
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
        n_samples_for_intrinsics=INTR_SAMPLES, device=dev)
    before_repair, repaired = [], []
    real_repair = initialize._repair_bad_intrinsics

    def repair(*a, **kw):
        before_repair[:] = [(K.copy(), d.copy()) for K, d in a[3]]
        changed = real_repair(*a, **kw)
        repaired[:] = [c for c, (K, d) in enumerate(a[3])
                       if not (np.array_equal(K, before_repair[c][0])
                               and np.array_equal(d, before_repair[c][1]))]
        return changed

    metrics.stage_times.clear()
    cal_walls, out = [], None
    initialize._repair_bad_intrinsics = repair
    try:
        for _ in range(CAL_TIMED):
            out, wall = timed(torch, call)
            cal_walls.append(wall)
    finally:
        initialize._repair_bad_intrinsics = real_repair
    stages = stage_text(metrics.stage_times, CAL_TIMED)
    ext, cal_intr, _, tree = out
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(before_repair, intr)), "calibrate's intrinsics differ from (a)'s")
    check(sorted([0] + [child for _, child in tree]) == list(range(C)),
          f"the spanning tree does not span the {C} cameras: {tree}")
    check(bool(np.isfinite(ext).all()), "non-finite extrinsics")
    rot, trans = relative_pose_errors(ext, rig.all_extrinsics)
    exempt = sorted(unstable_cameras(tree, np.isin(np.arange(C), unstable)[:, None]))
    held = [c for c in range(C) if c not in exempt]
    worst = (max(held, key=lambda c: rot[c]), max(held, key=lambda c: trans[c]))
    log("22c calibrate", f"{C} x {INTR_RIG['n_frames']}, batched route: wall "
        + walls_text(cal_walls) + f"; stages per call: {stages}; intrinsics equal (a)'s, "
        f"cameras the repair stage refit {repaired} (fx " + ", ".join(
            f"{intr[c][0][0, 0]:.2f} -> {cal_intr[c][0][0, 0]:.2f}" for c in repaired)
        + f"); tree over {C} cameras; relative to camera 0 against the rig, "
        f"over the {len(held)} cameras held: rotation max {rot[worst[0]]:.4e} rad (camera "
        f"{worst[0]}), median {np.median([rot[c] for c in held]):.4e}; translation max "
        f"{trans[worst[1]]:.4f} mm (camera {worst[1]}), median "
        f"{np.median([trans[c] for c in held]):.4f} mm (gates {CAL_ROT_RAD:g} rad, "
        f"{CAL_TRANS_MM:g} mm); an unstable camera or below one in the tree (gates "
        f"{CAL_UNSTABLE_ROT_RAD:g} rad, {CAL_UNSTABLE_TRANS_MM:g} mm): "
        + (", ".join(f"{c} ({rot[c]:.4e} rad, {trans[c]:.4f} mm)" for c in exempt) or "none"))
    check(rot[worst[0]] <= CAL_ROT_RAD and trans[worst[1]] <= CAL_TRANS_MM,
          f"calibrate's extrinsics off the rig's by {rot[worst[0]]:.3e} rad / "
          f"{trans[worst[1]]:.3f} mm")
    far = [c for c in exempt if not (rot[c] <= CAL_UNSTABLE_ROT_RAD
                                     and trans[c] <= CAL_UNSTABLE_TRANS_MM)]
    check(not far, "calibrate's extrinsics off the rig's on unstable cameras: " + ", ".join(
        f"camera {c}: {rot[c]:.3e} rad / {trans[c]:.3f} mm" for c in far))
    log("22 phase", f"{time.perf_counter() - t_phase:.1f} s")


def host_packages():
    """Which host packages the video and I/O modules can use here:
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
        ref = lm_core.ba_chunk_blocks_reference(*args)
        err, scaled = compare_blocks(got, ref)
        errs["ba_blocks_kernel"] = max(errs["ba_blocks_kernel"], err)
        cerr, trel = compare_cost(ba_cuda.ba_chunk_cost(*args),
                                  lm_core.ba_chunk_cost_reference(*args),
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
                             cuda_ms(torch, lambda: lm_core.ba_chunk_blocks_reference(*bench))),
        "ba_cost_kernel": (cuda_ms(torch, lambda: ba_cuda.ba_chunk_cost(*bench)),
                           cuda_ms(torch, lambda: lm_core.ba_chunk_cost_reference(*bench))),
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
        before = (launched("ba_blocks_kernel"), launched("ba_cost_kernel"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, p, info = lm_core.lm_solve(cam, poses0, obs, mask, objp, o)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        blocks = launched("ba_blocks_kernel") - before[0]
        costs = launched("ba_cost_kernel") - before[1]
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
    zero_launches("ba_blocks_kernel", "ba_cost_kernel")
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
    launches = {"ba_blocks_kernel": launched("ba_blocks_kernel"),
                "ba_cost_kernel": launched("ba_cost_kernel")}
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
    alone_us = rolling_phase(torch, dev, analysis, errs, launches, times, bounds)
    keep = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        videos = video_phase(torch, dev, errs, keep)
        sharded_phase(torch, dev, bench_rig, videos)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    intrinsics_phase(torch, dev)
    log("host packages", host_packages())

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1], "alone_us": alone_us.get(name),
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, replaces) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
