"""Export the JAX package's bundle adjustment of the bench rig for the port.

The port's ``chip_smoke.py`` (phases 10-11) runs the port's ``calibrate``
and ``bundle_adjust`` on the bench rig (6 cameras x 1000 frames, seed 11,
noise 0.3 px, dropout 0.25, ``n_samples_for_intrinsics=50``, bench.py:71-81)
on a machine without JAX, and holds them against the JAX package's own run
of the same calls. This script makes that run: JAX on the CPU with x64,
``mct.calibrate`` then ``mct.bundle_adjust`` with default options, and writes
``multicam_calibration_tpu_torch/data/bench_ba_ref.npz``:

- ``tree`` (C-1, 2) int: ``calibrate``'s spanning tree (parent, child);
- ``ext`` (C, 6), ``K`` (C, 3, 3), ``dist`` (C, 5), ``poses`` (F, 6):
  ``calibrate``'s outputs, the inputs of ``bundle_adjust`` below;
- ``pose_unstable`` (C, F) bool: camera-frames whose single-camera pose
  (``estimate_pose_batch`` at ``calibrate``'s intrinsics) left the
  converged basin (RMS reprojection error >= 5 px or |r| >= 2 pi) or moves
  by more than 1e-4 when the detections or the camera matrix are scaled by
  1 + 1e-15 or 1 - 1e-15: where the undamped planar Gauss-Newton is
  chaotic, and no other implementation can be expected to return the same
  pose;
- ``use_frames``: ``bundle_adjust``'s frame selection;
- ``adj_ext`` (C, 6), ``adj_K``, ``adj_dist``, ``adj_poses``
  (len(use_frames), 6): its adjusted parameters;
- ``final_cost``, ``initial_cost``, ``n_iters``, ``nfev``: its ``info``;
- ``rmse_px``: sqrt of the mean squared per-point reprojection error over
  the detected points of ``use_frames`` at the adjusted parameters;
- ``jax_commit``: the git commit of the JAX package that produced it.

Run from the repository root (~1 min on the CPU):

    python scripts/export_torch_bench_ba.py
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import multicam_calibration_tpu as mct

N_CAMERAS, N_FRAMES, SEED = 6, 1000, 11
OUT = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "bench_ba_ref.npz")


def _git_commit():
    out = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True,
        check=False,
    )
    return out.stdout.strip() or "unknown"


def pose_unstable(rig, intr):
    """(C, F) bool: see the module docstring."""
    from multicam_calibration_tpu.models.initialize import estimate_pose_batch

    Ks, ds = [k for k, _ in intr], [d for _, d in intr]
    uvs = rig.all_calib_uvs
    poses = np.asarray(estimate_pose_batch(uvs, rig.calib_objpoints, Ks, ds))
    moved = np.zeros(poses.shape[:2], bool)
    for s in (1 + 1e-15, 1 - 1e-15):
        for nudged in (estimate_pose_batch(uvs * s, rig.calib_objpoints, Ks, ds),
                       estimate_pose_batch(uvs, rig.calib_objpoints, [K * s for K in Ks], ds)):
            moved |= np.abs(np.nan_to_num(poses - np.asarray(nudged))).max(-1) > 1e-4
    out = np.zeros(poses.shape[:2], bool)
    for c, (K, d) in enumerate(intr):
        pred = np.asarray(mct.predict_calib_uvs([np.zeros(6)], [(K, d)], rig.calib_objpoints,
                                                np.nan_to_num(poses[c])))[0]
        rms = np.sqrt(((uvs[c] - pred) ** 2).sum(-1).mean(-1))
        seen = ~np.isnan(poses[c, :, 0])
        out[c] = seen & (moved[c] | ~(rms < 5.0)
                         | ~(np.linalg.norm(poses[c, :, :3], axis=-1) < 2 * np.pi))
    return out


def main():
    rig = mct.make_synthetic_rig(
        n_cameras=N_CAMERAS, n_frames=N_FRAMES, noise_px=0.3, dropout=0.25,
        seed=SEED,
    )
    ext, intr, poses, tree = mct.calibrate(
        rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints,
        verbose=False, n_samples_for_intrinsics=50,
    )
    adj_ext, adj_intr, adj_poses, use_frames, info = mct.bundle_adjust(
        rig.all_calib_uvs, ext, intr, rig.calib_objpoints, poses, verbose=False,
    )
    pred = np.asarray(mct.predict_calib_uvs(adj_ext, adj_intr, rig.calib_objpoints,
                                            adj_poses))
    err = np.linalg.norm(rig.all_calib_uvs[:, use_frames] - pred, axis=-1)
    rmse = float(np.sqrt(np.nanmean(err**2)))
    np.savez_compressed(
        OUT, tree=np.asarray(tree, np.int64).reshape(-1, 2),
        ext=np.asarray(ext, np.float64), K=np.stack([np.asarray(k) for k, _ in intr]),
        dist=np.stack([np.asarray(d) for _, d in intr]), poses=np.asarray(poses, np.float64),
        pose_unstable=pose_unstable(rig, intr), use_frames=np.asarray(use_frames),
        adj_ext=np.asarray(adj_ext, np.float64),
        adj_K=np.stack([np.asarray(k) for k, _ in adj_intr]),
        adj_dist=np.stack([np.asarray(d) for _, d in adj_intr]),
        adj_poses=np.asarray(adj_poses, np.float64), final_cost=float(info["final_cost"]),
        initial_cost=float(info["initial_cost"]), n_iters=int(info["n_iters"]),
        nfev=int(info["nfev"]), rmse_px=rmse, jax_commit=_git_commit(),
    )
    print(f"wrote {OUT}: tree {tree}, {len(use_frames)} frames, final cost "
          f"{float(info['final_cost']):.6f} in {int(info['n_iters'])} iterations, "
          f"RMSE {rmse:.4f} px")


if __name__ == "__main__":
    main()
