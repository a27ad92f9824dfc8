"""Export detection frames and the JAX package's answers for the PyTorch port.

The port's ``chip_smoke.py`` checks detection on the GPU against the JAX
package, but the GPU machine has neither JAX nor OpenCV, so it can neither
render the frames nor run the reference. This script does both on the CPU
and writes ``multicam_calibration_tpu_torch/data/detect_frames.npz``:

- ``frames`` (F, 480, 640) uint8 renders of a 5x7 board
  (``synthetic_images``): 8 clean views with the detection bench's seeds and
  noise (scripts/bench_detection.py:158-165), 4 ``HARD_KW`` views
  (lens distortion, lighting gradient, vignette, clutter;
  tests/test_detection.py:141-160) and 2 views each at 12 and 16 px motion
  blur (tests/test_detection.py:784-799);
- ``kind``, ``seed``: what each frame is; ``gt`` (F, 35, 2): ground truth;
- ``accepted`` (F,), ``uvs`` (A, 35, 2), ``scores`` (A, 4): JAX
  ``detect_chessboard_batch``'s answer for the accepted frames, in order;
- ``needs_ladder`` (F,): the frame is not detected without the coarse sigma
  ladder (JAX run with ``_COARSE_SCALES`` emptied);
- ``cand_xy`` (F, 160, 2), ``cand_score`` (F, 160): JAX's stage-1
  candidates (``_find_candidates``);
- ``board_shape``, ``match_score_min_diff``, ``jax_commit``.

A frame is left out when JAX rejects it or when its anchor margin lies
within 0.02 of ``match_score_min_diff``, so that f32 rounding on another
device cannot flip the decision. Run from the repository root:

    python scripts/export_torch_detect_frames.py
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
from multicam_calibration_tpu.detection.synthetic_images import (
    random_view_homography,
    render_board_view,
)

OUT = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "detect_frames.npz")
BOARD = (5, 7)
MIN_DIFF = 0.2
K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=np.array([-0.28, 0.12]), lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)
# (kind, homography seed, view seed, noise, render kwargs)
SPECS = (
    [("clean", k, k, 1.5, {}) for k in range(8)]
    + [("hard", 100 + k, k, 2.0, HARD_KW) for k in range(4)]
    + [(f"blur{b}", 300 + k, k, 2.0, dict(motion_blur_px=b)) for b in (12, 16) for k in range(2)]
)


def _git_commit():
    out = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True, check=False,
    )
    return out.stdout.strip() or "unknown"


def main():
    frames, gts = [], []
    for _, seed, view_seed, noise, kw in SPECS:
        H = random_view_homography(np.random.default_rng(seed), board_shape=BOARD)
        v, gt = render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=noise, seed=view_seed, **kw
        )
        frames.append(v.astype(np.uint8))
        gts.append(gt)
    det = jdet.detect_chessboard_batch(frames, board_shape=BOARD, match_score_min_diff=MIN_DIFF)
    keep = []
    for i, (kind, seed, *_rest) in enumerate(SPECS):
        if i not in det:
            print(f"leave out {kind} seed {seed}: JAX rejects it")
            continue
        margin = float(det[i][1][0] - det[i][1][1])
        if abs(margin - MIN_DIFF) < 0.02:
            print(f"leave out {kind} seed {seed}: anchor margin {margin:.4f}")
            continue
        keep.append(i)
    frames = np.stack([frames[i] for i in keep])
    det = jdet.detect_chessboard_batch(list(frames), board_shape=BOARD, match_score_min_diff=MIN_DIFF)
    saved = jdet._COARSE_SCALES
    jdet._COARSE_SCALES = ()
    try:
        no_ladder = jdet.detect_chessboard_batch(
            list(frames), board_shape=BOARD, match_score_min_diff=MIN_DIFF
        )
    finally:
        jdet._COARSE_SCALES = saved
    gray = jdet._gray_from_u8(jnp.asarray(frames))
    cand_xy, cand_score = jdet._find_candidates(gray, 160, 4)
    acc = np.array([i in det for i in range(len(keep))])
    np.savez_compressed(
        OUT,
        frames=frames,
        kind=np.array([SPECS[i][0] for i in keep]),
        seed=np.array([SPECS[i][1] for i in keep]),
        gt=np.stack([gts[i] for i in keep]),
        accepted=acc,
        uvs=np.stack([np.asarray(det[i][0], np.float64) for i in range(len(keep)) if acc[i]]),
        scores=np.stack([np.asarray(det[i][1], np.float64) for i in range(len(keep)) if acc[i]]),
        needs_ladder=np.array([i not in no_ladder for i in range(len(keep))]),
        cand_xy=np.asarray(cand_xy, np.float32),
        cand_score=np.asarray(cand_score, np.float32),
        board_shape=np.array(BOARD),
        match_score_min_diff=MIN_DIFF,
        jax_commit=_git_commit(),
    )
    print(f"wrote {OUT}: {len(keep)} frames, {int(acc.sum())} accepted, "
          f"{os.path.getsize(OUT) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
