"""Export the JAX package's low-band and scale_factor answers for the PyTorch port.

The port's ``chip_smoke.py`` holds its low-band batch path
(``detect_chessboard_batch(..., coarse_downscale=f)``) and its single-frame
``scale_factor`` path against the JAX package on the GPU, which has no JAX.
This script runs JAX on the CPU over the 16 frames of
``multicam_calibration_tpu_torch/data/detect_frames.npz`` (read from there,
not copied) and writes ``multicam_calibration_tpu_torch/data/detect_lowband.npz``:

- ``low{f}_accepted`` (16,), ``low{f}_uvs`` (A, 35, 2), ``low{f}_scores``
  (A, 4), ``low{f}_margin`` (A,): ``detect_chessboard_batch`` with
  ``coarse_downscale=f`` for f = 2 and 3, the accepted frames in order;
- ``scale{s}_accepted``, ``scale{s}_uvs``, ``scale{s}_scores``,
  ``scale{s}_margin`` for ``detect_chessboard(..., scale_factor=s)``,
  s = 0.5 and 0.75 (keys ``scale050``, ``scale075``);
- ``resize_frame``, ``resize_scale``, ``resize_gray``: frame 0's gray
  resized by ``jax.image.resize(..., "bilinear")`` at 0.75 (f32);
- ``board_shape``, ``jax_commit``.

Run from the repository root (JAX on the CPU, ~1 min):

    python scripts/export_torch_detect_lowband.py
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

import jax.numpy as jnp

from multicam_calibration_tpu.detection import detector as jdet

DATA = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data")
OUT = os.path.join(DATA, "detect_lowband.npz")
FACTORS = (2, 3)
SCALES = (0.5, 0.75)
RESIZE_FRAME, RESIZE_SCALE = 0, 0.75


def _git_commit():
    out = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True, check=False,
    )
    return out.stdout.strip() or "unknown"


def _answers(prefix, det, n):
    """The accepted mask, corners, sorted scores and anchor margins of one
    run, under ``prefix``."""
    acc = np.array([i in det for i in range(n)])
    keys = [i for i in range(n) if acc[i]]
    scores = np.stack([np.asarray(det[i][1], np.float64) for i in keys])
    return {
        f"{prefix}_accepted": acc,
        f"{prefix}_uvs": np.stack([np.asarray(det[i][0], np.float64) for i in keys]),
        f"{prefix}_scores": scores,
        f"{prefix}_margin": scores[:, 0] - scores[:, 1],
    }


def main():
    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    frames = list(d["frames"])
    board = tuple(int(v) for v in d["board_shape"])
    out = {}
    for f in FACTORS:
        det = jdet.detect_chessboard_batch(frames, board_shape=board, coarse_downscale=f)
        out.update(_answers(f"low{f}", det, len(frames)))
    for s in SCALES:
        det = {}
        for i, fr in enumerate(frames):
            r = jdet.detect_chessboard(fr, board_shape=board, scale_factor=s)
            if r is not None:
                det[i] = r
        out.update(_answers(f"scale{int(round(100 * s)):03d}", det, len(frames)))
    gray = jdet._to_gray_f(frames[RESIZE_FRAME])
    h, w = gray.shape
    shape = (int(round(h * RESIZE_SCALE)), int(round(w * RESIZE_SCALE)))
    resized = np.asarray(jax.image.resize(gray, shape, method="bilinear"), np.float32)
    np.savez_compressed(
        OUT, **out, resize_frame=RESIZE_FRAME, resize_scale=RESIZE_SCALE, resize_gray=resized,
        board_shape=np.array(board), jax_commit=_git_commit(),
    )
    for k in sorted(out):
        if k.endswith("_accepted"):
            p = k[: -len("_accepted")]
            print(f"{p}: accepted {int(out[k].sum())}/{len(frames)}, smallest margin "
                  f"{out[p + '_margin'].min():.4f}")
    print(f"wrote {OUT}: {os.path.getsize(OUT) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
