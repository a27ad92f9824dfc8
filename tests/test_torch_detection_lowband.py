"""The low-band batch path (``coarse_downscale = f > 1``): PyTorch port vs JAX, CPU.

The same numpy frames go through both packages:

- ``_decimate_u8``: bit-equal (integer arithmetic), gray and BGR, f = 2, 3,
  15 and 16 (the port's uint16 / uint32 switch) and 17 (where the JAX
  package's comment says a uint16 sum overflows);
- ``_refine_u8_patches`` from the same starts: within 1e-5 px (f32 sums in
  other orders);
- ``detect_chessboard_batch(..., coarse_downscale=f)`` on clean views at
  f = 2 and 3 and on BGR frames: the same accepted frames, corners within
  0.01 px (hence the same orientation), sorted anchor scores within 1e-3;
  and within 0.25 px of the full-resolution path;
- the JAX answers stored in ``data/detect_lowband.npz`` (what the GPU smoke
  run checks) against the port's CPU run.

The hard frames and the escalation are in
tests/test_torch_detection_lowband_hard.py.
"""
import os

import numpy as np
import pytest
import torch

from multicam_calibration_tpu.detection import detector as jdet
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import detector as tdet
from multicam_calibration_tpu_torch.detection import synthetic_images as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data")
BOARD = (5, 7)
K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=np.array([-0.28, 0.12]), lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)


def _views(n, seed0, **kw):
    """tests/test_detection_lowband.py's renders."""
    frames = []
    for k in range(n):
        H = tsyn.random_view_homography(np.random.default_rng(seed0 + k), board_shape=BOARD)
        v, _ = tsyn.render_board_view(H, out_size=(480, 640), board_shape=BOARD, noise=1.5,
                                      seed=seed0 + k, **kw)
        frames.append(v.astype(np.uint8))
    return frames


def _assert_same_detections(got, ref, label=""):
    assert sorted(got) == sorted(ref), f"{label} accepted {sorted(got)} vs {sorted(ref)}"
    for i in ref:
        np.testing.assert_allclose(np.asarray(got[i][0], float), np.asarray(ref[i][0], float),
                                   atol=0.01, err_msg=f"{label} frame {i}")
        np.testing.assert_allclose(np.asarray(got[i][1], float), np.asarray(ref[i][1], float),
                                   atol=1e-3, err_msg=f"{label} frame {i}")


@pytest.fixture(scope="module")
def clean():
    return _views(4, 3100)


@pytest.mark.parametrize("f", [2, 3, 15, 16, 17])
@pytest.mark.parametrize("channels", [(), (3,)], ids=["gray", "bgr"])
def test_decimate_u8_matches_jax(f, channels):
    rng = np.random.default_rng(f)
    frames = rng.integers(0, 256, (2, 6 * f - 1, 8 * f - 1) + channels, dtype=np.uint8)
    frames[0, :f, :f] = 255  # a saturated block: f^2 * 255 + f^2 // 2 > 65535 from f = 16
    got = tdet._decimate_u8(frames, f)
    assert got.dtype == np.uint8 and got.shape == (2, 5, 7) + channels
    np.testing.assert_array_equal(got, jdet._decimate_u8(frames, f))
    assert (got[0, 0, 0] == 255).all()


@pytest.mark.parametrize("channels", [(), (3,)], ids=["gray", "bgr"])
def test_refine_u8_patches_matches_jax(clean, channels):
    """Patches cut around stage-1 candidates of a clean view, refined from
    starts 1.3 px off."""
    import jax.numpy as jnp

    win, R = 5, 5 + 3 + 1
    S2 = 2 * R + 3
    frame = clean[0] if not channels else np.stack([clean[0]] * 3, -1)
    xy = tdet._batch_dispatch([clean[0]], 160, 4, win, BOARD, 40, torch.device("cpu"))[1][0]
    cxy = np.rint(xy.numpy()[:20]).astype(np.int64)
    ox = np.clip(cxy[:, 0] - (R + 1), 0, frame.shape[1] - S2)
    oy = np.clip(cxy[:, 1] - (R + 1), 0, frame.shape[0] - S2)
    patches = np.stack([frame[y : y + S2, x : x + S2] for x, y in zip(ox, oy)])
    q0 = (cxy - np.stack([ox + 1, oy + 1], -1) + 1.3).astype(np.float32)
    got = tdet._refine_u8_patches(torch.as_tensor(patches), torch.as_tensor(q0), win).numpy()
    ref = np.asarray(jdet._refine_u8_patches(jnp.asarray(patches), jnp.asarray(q0), win))
    assert np.abs(got - q0).max() > 0.1  # the refinement moved
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("f", [2, 3])
def test_lowband_batch_matches_jax(clean, f):
    got = tmct.detect_chessboard_batch(clean, board_shape=BOARD, coarse_downscale=f,
                                       device="cpu")
    ref = jdet.detect_chessboard_batch(clean, board_shape=BOARD, coarse_downscale=f)
    assert sorted(ref) == list(range(len(clean)))
    _assert_same_detections(got, ref, f"f={f}")
    full = tmct.detect_chessboard_batch(clean, board_shape=BOARD, device="cpu")
    for i in full:  # full-res accuracy (tests/test_detection_lowband.py:75-87)
        assert np.abs(got[i][0] - full[i][0]).max() < 0.25


def test_lowband_bgr_frames_match_jax(clean):
    rgb = [np.stack([fr] * 3, -1) for fr in clean[:2]]
    got = tmct.detect_chessboard_batch(rgb, board_shape=BOARD, coarse_downscale=2, device="cpu")
    ref = jdet.detect_chessboard_batch(rgb, board_shape=BOARD, coarse_downscale=2)
    assert sorted(ref) == [0, 1]
    _assert_same_detections(got, ref, "bgr")


def test_stored_jax_answers_match_port_cpu_run():
    """data/detect_lowband.npz (scripts/export_torch_detect_lowband.py) holds
    JAX's low-band answers on data/detect_frames.npz's frames; the port's CPU
    run agrees with them (chip_smoke phase 12 holds the card to the same)."""
    d = np.load(os.path.join(DATA, "detect_frames.npz"))
    low = np.load(os.path.join(DATA, "detect_lowband.npz"))
    assert os.path.getsize(os.path.join(DATA, "detect_lowband.npz")) <= 1 << 20
    board = tuple(int(v) for v in low["board_shape"])
    for f in (2, 3):
        got = tmct.detect_chessboard_batch(list(d["frames"]), board_shape=board,
                                           coarse_downscale=f, device="cpu")
        acc = np.nonzero(low[f"low{f}_accepted"])[0]
        ref = {int(i): (low[f"low{f}_uvs"][j], low[f"low{f}_scores"][j])
               for j, i in enumerate(acc)}
        _assert_same_detections(got, ref, f"stored f={f}")
