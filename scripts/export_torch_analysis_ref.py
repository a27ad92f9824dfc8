"""Export the JAX package's answers for the port's analysis modules.

``chip_smoke.py`` phases 16-19 hold the port's ``calibration_uncertainty``,
``triangulate``, flatibration and ``RollingCalibrator`` against the JAX
package on a machine without JAX. This script runs JAX on the CPU with x64
on inputs made from seeds by ``chip_smoke``'s own helpers (the bench rig,
``floor_points``, ``triangulation_views``, ``stream_start``), and writes
``multicam_calibration_tpu_torch/data/analysis_ref.npz``, which holds only
JAX's answers and the RANSAC samples:

- ``unc_camera_sd`` (6, 12), ``unc_pose_sd`` (F, 6), ``unc_sigma_px``,
  ``unc_dof``: ``calibration_uncertainty`` at JAX's adjusted bench result
  (``data/bench_ba_ref.npz``: its frames, cameras and poses);
- ``tri_median`` (P, 3), ``tri_points`` (P, 3), ``tri_sd`` (P, 3):
  ``triangulate(refine=False)`` and ``triangulate(return_sd=True)`` of the
  bench rig's first ``TRI_FRAMES`` frames at JAX's adjusted cameras;
- ``floor_idx`` (256, 3): the samples ``jax.random.randint(PRNGKey(0),
  (256, 3), 0, n)`` that JAX's ``ransac_plane_fit`` draws; ``floor_mask``,
  ``floor_plane`` (a, b, t): its fit; ``floor_transform``, ``floor_flip``,
  ``floor_center``: ``flatibrate``, ``flip_z_axis`` and ``center_arena``
  (midrange) on ``floor_points(**FLOOR)``;
- ``stream_options``: JSON of the ``LMOptions`` fields of the f64 stream;
  ``stream_ext`` (U, C, 6), ``stream_cost``, ``stream_n_iters``,
  ``stream_admitted``, ``stream_occupancy`` (U,), ``stream_order`` (U, W):
  a ``RollingCalibrator`` after each of U updates on ``STREAM_F64``;
- ``jax_commit``: the git commit that produced it.

Run from the repository root (~1 min on the CPU):

    python scripts/export_torch_analysis_ref.py
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

import chip_smoke as cs
import multicam_calibration_tpu as mct
from multicam_calibration_tpu.models import flatibration
from multicam_calibration_tpu.models.lm_core import LMOptions
from multicam_calibration_tpu.models.streaming import RollingCalibrator

OUT = os.path.join(cs.DATA, "analysis_ref.npz")


def _git_commit():
    out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                         text=True, check=False)
    return out.stdout.strip() or "unknown"


def uncertainty_and_triangulation(out):
    ref = np.load(os.path.join(cs.DATA, "bench_ba_ref.npz"))
    rig = mct.make_synthetic_rig(**cs.RIG)
    intr = list(zip(ref["adj_K"], ref["adj_dist"]))
    unc = mct.calibration_uncertainty(rig.all_calib_uvs[:, ref["use_frames"]], ref["adj_ext"],
                                      intr, rig.calib_objpoints, ref["adj_poses"])
    out.update(unc_camera_sd=unc["camera_sd"], unc_pose_sd=unc["pose_sd"],
               unc_sigma_px=unc["sigma_px"], unc_dof=unc["dof"])
    views, _ = cs.triangulation_views(rig, cs.TRI_FRAMES)
    med = mct.triangulate(views, list(ref["adj_ext"]), intr, refine=False)
    pts, sd = mct.triangulate(views, list(ref["adj_ext"]), intr, return_sd=True)
    out.update(tri_median=np.asarray(med), tri_points=np.asarray(pts), tri_sd=np.asarray(sd))


def floor(out):
    pts, _ = cs.floor_points(**cs.FLOOR)
    idx = jax.random.randint(jax.random.PRNGKey(0), (256, 3), 0, len(pts))
    a, b, t, mask = flatibration.ransac_plane_fit(jnp.asarray(pts))
    transform = mct.flatibrate(pts)
    out.update(floor_idx=np.asarray(idx), floor_mask=np.asarray(mask),
               floor_plane=np.array([float(a), float(b), float(t)]),
               floor_transform=transform, floor_flip=mct.flip_z_axis(transform),
               floor_center=mct.center_arena(transform, pts))


def stream(out):
    p = cs.STREAM_F64
    rig = mct.make_synthetic_rig(n_cameras=p["n_cameras"], n_frames=p["n_frames"],
                                 noise_px=cs.NOISE_PX, dropout=0.25, seed=p["seed"])
    ext, intr = cs.stream_start(rig, p["seed"])
    opts = LMOptions(max_iters=p["iters"], ftol=0.0)  # JAX's own recipe on the CPU
    rc = RollingCalibrator(ext, intr, rig.calib_objpoints, window=p["window"],
                           protect_recent=p["protect"], lm_options=opts)
    rows = []
    for lo in range(0, p["n_frames"], p["batch"]):
        info = rc.update(rig.all_calib_uvs[:, lo:lo + p["batch"]])
        rows.append((rc.calibration()[0], info, rc._order.copy()))
    out.update(
        stream_options=json.dumps(dataclasses.asdict(opts)),
        stream_ext=np.stack([r[0] for r in rows]),
        stream_cost=np.array([r[1]["cost"] for r in rows]),
        stream_n_iters=np.array([r[1]["n_iters"] for r in rows]),
        stream_admitted=np.array([r[1]["admitted"] for r in rows]),
        stream_occupancy=np.array([r[1]["occupancy"] for r in rows]),
        stream_order=np.stack([r[2] for r in rows]),
    )


def main():
    out = {"jax_commit": _git_commit()}
    uncertainty_and_triangulation(out)
    floor(out)
    stream(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): uncertainty dof {out['unc_dof']}, "
          f"sigma {out['unc_sigma_px']:.6f} px; {len(out['tri_points'])} triangulated points; "
          f"{int(out['floor_mask'].sum())} floor inliers; stream costs "
          + ", ".join(f"{c:.6f}" for c in out["stream_cost"]))


if __name__ == "__main__":
    main()
