"""Command-line interface: detect / calibrate / adjust / export / flatibrate /
benchmark.

Counterpart of ``multicam_calibration_tpu/cli.py`` (the ``mcc`` command),
with the same commands, arguments and outputs, over the port's functions.
Every command that computes takes ``--device`` (``cuda`` by default; the
run raises without a card, ``--device cpu`` runs on the CPU).

Usage examples::

    python -m multicam_calibration_tpu_torch detect cam*.mp4 --board 5 7 \\
        --square-size 12.5
    python -m multicam_calibration_tpu_torch calibrate cam*.mp4 --output calib.json
    python -m multicam_calibration_tpu_torch benchmark --n-cameras 6 --n-frames 1000
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.config import PipelineConfig, load_config


def _add_board_args(p):
    p.add_argument("--board", nargs=2, type=int, default=None,
                   metavar=("ROWS", "COLS"), help="interior corners (rows cols)")
    p.add_argument("--square-size", type=float, default=None, help="square size (mm)")
    p.add_argument("--config", default=None, help="YAML config path")


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda; cpu for the CPU)")


def _device(args):
    from .device import cuda_device, resolve_device

    return cuda_device() if args.device == "cuda" else resolve_device(args.device)


def _config_from_args(args):
    cfg = load_config(args.config) if args.config else PipelineConfig()
    if getattr(args, "board", None):
        cfg.board.shape = tuple(args.board)
    if getattr(args, "square_size", None):
        cfg.board.square_size = args.square_size
    return cfg


def _load_detections(video_paths, cfg, device, overwrite=False):
    from .detection import detect_chessboard
    from .detection.video import run_calibration_detection

    options = {
        "board_shape": tuple(cfg.board.shape),
        "scale_factor": cfg.detection.scale_factor,
        "match_score_min_diff": cfg.detection.match_score_min_diff,
        "max_candidates": cfg.detection.max_candidates,
        "nms_radius": cfg.detection.nms_radius,
        "reorder": cfg.detection.reorder,
    }
    return run_calibration_detection(
        video_paths, detect_chessboard, options, overwrite=overwrite, device=device
    )


def cmd_detect(args):
    cfg = _config_from_args(args)
    uvs, img_sizes = _load_detections(args.videos, cfg, _device(args),
                                      overwrite=args.overwrite)
    n_det = (~np.isnan(uvs).any((-1, -2))).sum(1)
    for path, n in zip(args.videos, n_det):
        print(f"{path}: {n} frames with detections")
    return 0


def _calibrate_from_detections(uvs, img_sizes, cfg, names, output, fmt, no_adjust,
                               device):
    """``calibrate`` -> ``bundle_adjust`` -> ``compute_residual_metric`` ->
    ``save_calibration`` on NaN-padded detections (C, F, N, 2): the body of
    the ``calibrate`` command after detection. Returns (extrinsics,
    intrinsics, board poses, frames; the median residual per camera and
    bundle_adjust's info, both None with ``no_adjust``): the adjusted poses
    of bundle_adjust's frames, or calibrate's poses of every frame."""
    from .detection import generate_chessboard_objpoints
    from .models.bundle_adjustment import bundle_adjust
    from .models.initialize import calibrate
    from .utils.io import save_calibration
    from .viz import compute_residual_metric

    objpoints = generate_chessboard_objpoints(tuple(cfg.board.shape), cfg.board.square_size)
    ext, intr, poses, tree = calibrate(
        uvs, img_sizes, objpoints,
        root=cfg.init.root_camera,
        n_samples_for_intrinsics=cfg.init.n_samples_for_intrinsics,
        device=device,
    )
    med = info = None
    use_frames = np.arange(uvs.shape[1])
    if not no_adjust:
        ext, intr, poses, use_frames, info = bundle_adjust(
            uvs, ext, intr, objpoints, poses,
            n_frames=cfg.ba.n_frames,
            outlier_threshold=cfg.ba.outlier_threshold,
            ftol=cfg.ba.ftol,
            loss=cfg.ba.loss,
            max_iters=cfg.ba.max_iters,
            frame_chunk=cfg.ba.frame_chunk,
            device=device,
        )
        med, _, _ = compute_residual_metric(
            uvs[:, use_frames], ext, intr, objpoints, poses, device=device
        )
        print("median reprojection error (board units):", np.round(med, 4).tolist())
    save_calibration(ext, intr, names, output, save_format=fmt)
    print(f"saved calibration to {output} ({fmt})")
    return ext, intr, poses, use_frames, med, info


def cmd_calibrate(args):
    cfg = _config_from_args(args)
    dev = _device(args)
    uvs, img_sizes = _load_detections(args.videos, cfg, dev, overwrite=args.overwrite)
    names = [os.path.splitext(os.path.basename(v))[0] for v in args.videos]
    _calibrate_from_detections(uvs, img_sizes, cfg, names, args.output, args.format,
                               args.no_adjust, dev)
    return 0


def cmd_adjust(args):
    """Re-run bundle adjustment from a saved calibration + detection caches."""
    from .detection import generate_chessboard_objpoints
    from .models.bundle_adjustment import bundle_adjust
    from .models.initialize import consensus_calib_poses, estimate_pose
    from .utils.io import load_calibration, save_calibration

    cfg = _config_from_args(args)
    dev = _device(args)
    uvs, img_sizes = _load_detections(args.videos, cfg, dev)
    objpoints = generate_chessboard_objpoints(tuple(cfg.board.shape), cfg.board.square_size)
    ext, intr, names = load_calibration(args.calibration, load_format=args.format)
    all_poses = np.stack([
        estimate_pose(uvs[c], objpoints, *intr[c], device=dev).cpu().numpy()
        for c in range(len(ext))
    ])
    poses = consensus_calib_poses(all_poses, np.asarray(ext), device=dev).cpu().numpy()
    ext2, intr2, poses2, use_frames, info = bundle_adjust(
        uvs, np.asarray(ext), intr, objpoints, poses,
        n_frames=cfg.ba.n_frames, ftol=cfg.ba.ftol, max_iters=cfg.ba.max_iters,
        frame_chunk=cfg.ba.frame_chunk,
        checkpoint_path=getattr(args, "checkpoint", None),
        device=dev,
    )
    save_calibration(ext2, intr2, names, args.output, save_format=args.format)
    print(f"saved adjusted calibration to {args.output}")
    if getattr(args, "uncertainty", False):
        from .models.uncertainty import calibration_uncertainty

        unc = calibration_uncertainty(
            uvs[:, use_frames], ext2, intr2, objpoints, poses2, device=dev
        )
        print(f"observation noise: {unc['sigma_px']:.3f} px (dof {unc['dof']:.0f})")
        sd = unc["camera_sd"]
        for c, name in enumerate(names):
            print(
                f"  {name}: fx±{sd[c, 0]:.2f} fy±{sd[c, 1]:.2f} "
                f"cx±{sd[c, 2]:.2f} cy±{sd[c, 3]:.2f} "
                f"k1±{sd[c, 4]:.4f} k2±{sd[c, 5]:.4f} "
                f"rot±{sd[c, 6:9].max():.2e} rad "
                f"trans±{sd[c, 9:12].max():.2f}"
            )
    return 0


def cmd_export(args):
    """Convert a calibration between formats."""
    from .utils.io import load_calibration, save_calibration

    ext, intr, names = load_calibration(args.input, load_format=args.from_format)
    save_calibration(ext, intr, names, args.output, save_format=args.to_format)
    print(f"converted {args.input} ({args.from_format}) -> {args.output} "
          f"({args.to_format})")
    return 0


def cmd_flatibrate(args):
    from .models.flatibration import center_arena, flatibrate, flip_z_axis, get_floor_points
    from .utils.io import require_h5py

    h5py = require_h5py("the keypoints file")
    dev = _device(args)
    with h5py.File(args.keypoints, "r") as h5:
        keypoints = h5[args.dataset][:]
    floor = get_floor_points(keypoints, z_points_down=args.z_down)
    t = flatibrate(floor, residual_threshold=args.residual_threshold, device=dev)
    if args.center:
        t = center_arena(t, floor, device=dev)
    if args.flip_z:
        t = flip_z_axis(t, device=dev)
    np.save(args.output, np.asarray(t))
    print(f"saved flatibration transform to {args.output}")
    return 0


def cmd_benchmark(args):
    """Synthetic-rig benchmark: one timed ``lm_solve`` after a warm-up, on
    the recipe ``bundle_adjust`` applies on the device (f64 data with f32
    Jacobians; on CUDA also f32 blocks, solve, products and per-try cost,
    which runs both BA kernels)."""
    import time

    import torch

    from .models.bundle_adjustment import _params_to_arrays
    from .models.initialize import calibrate
    from .models.lm_core import LMOptions, accelerator_recipe, lm_solve
    from .synthetic import make_synthetic_rig

    dev = _device(args)
    rig = make_synthetic_rig(
        n_cameras=args.n_cameras, n_frames=args.n_frames,
        noise_px=0.3, dropout=0.25, seed=args.seed,
    )
    ext, intr, poses, _ = calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50, device=dev,
    )
    full = ~np.isnan(rig.all_calib_uvs).any((-1, -2))
    use = np.nonzero(full.sum(0) > 1)[0]
    obs_np = rig.all_calib_uvs[:, use]
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    obs = as_t(np.nan_to_num(obs_np))
    mask = as_t(~np.isnan(obs_np).any(-1))
    cam0 = as_t(_params_to_arrays(ext, intr))
    poses0 = as_t(np.nan_to_num(np.asarray(poses)[use]))
    objp = as_t(rig.calib_objpoints)
    opts = LMOptions(max_iters=args.max_iters, **{"jac_dtype": "float32",
                                                  **accelerator_recipe(dev)})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lm_solve(cam0, poses0, obs, mask, objp, opts)  # warm-up
    sync()
    t0 = time.perf_counter()
    cam, p, info = lm_solve(cam0 + 1e-6, poses0, obs, mask, objp, opts)
    sync()
    wall = time.perf_counter() - t0
    n_iters = int(info["n_iters"])
    print(json.dumps({
        "n_cameras": args.n_cameras,
        "n_frames": int(len(use)),
        "wall_s": round(wall, 4),
        "n_iters": n_iters,
        "iters_per_s": round(n_iters / wall, 2),
        "final_cost": float(info["final_cost"]),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
    }))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="multicam_calibration_tpu_torch",
        description="multi-camera calibration on one NVIDIA GPU (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("detect", help="run chessboard detection on videos")
    p.add_argument("videos", nargs="+")
    p.add_argument("--overwrite", action="store_true")
    _add_board_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("calibrate", help="full pipeline: detect -> init -> BA -> save")
    p.add_argument("videos", nargs="+")
    p.add_argument("--output", default="calibration.json")
    p.add_argument("--format", default="json", choices=["json", "jarvis", "gimbal"])
    p.add_argument("--no-adjust", action="store_true", help="skip bundle adjustment")
    p.add_argument("--overwrite", action="store_true")
    _add_board_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("adjust", help="re-run BA from saved calibration")
    p.add_argument("videos", nargs="+")
    p.add_argument("--calibration", required=True)
    p.add_argument("--output", default="calibration_adjusted.json")
    p.add_argument("--format", default="json", choices=["json", "jarvis", "gimbal"])
    p.add_argument(
        "--checkpoint", default=None,
        help="npz path for resumable optimizer state (saved every few iters)",
    )
    p.add_argument(
        "--uncertainty", action="store_true",
        help="print per-parameter standard errors at the optimum",
    )
    _add_board_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_adjust)

    p = sub.add_parser("export", help="convert calibration between formats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--from-format", required=True, choices=["json", "jarvis", "gimbal"])
    p.add_argument("--to-format", required=True, choices=["json", "jarvis", "gimbal"])
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("flatibrate", help="fit arena-floor alignment transform")
    p.add_argument("keypoints", help="HDF5 file with 3D keypoints")
    p.add_argument("--dataset", default="keypoints")
    p.add_argument("--output", default="flatibration.npy")
    p.add_argument("--z-down", action="store_true")
    p.add_argument("--residual-threshold", type=float, default=10.0)
    p.add_argument("--center", action="store_true")
    p.add_argument("--flip-z", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_flatibrate)

    p = sub.add_parser("benchmark", help="synthetic BA benchmark")
    p.add_argument("--n-cameras", type=int, default=6)
    p.add_argument("--n-frames", type=int, default=1000)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=11)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_benchmark)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
