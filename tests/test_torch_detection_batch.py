"""Chessboard detection, the whole batch pipeline: PyTorch port vs JAX, CPU.

- ``detect_chessboard_batch`` on 4 clean + 2 HARD_KW + 2 motion-blur views
  (the seeds of tests/test_detection.py): the same accepted frames, corners
  within 0.01 px (hence the same orientation), sorted anchor scores within
  1e-3 (the stages agree to f32 rounding, tests/test_torch_detection.py);
  ``detect_chessboard`` at B = 1 and ``reorder=False``;
- what the entry points refuse: unknown keyword arguments, and
  ``device=None`` without a CUDA device on every route;
- the JAX answers stored in ``data/detect_frames.npz`` (what the GPU smoke
  run checks) against the port's CPU run on the stored frames.
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
DETECT_FRAMES = os.path.join(ROOT, "multicam_calibration_tpu_torch", "data", "detect_frames.npz")
BOARD = (5, 7)
K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=np.array([-0.28, 0.12]), lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)


def _render(seed, view_seed, noise, **kw):
    H = tsyn.random_view_homography(np.random.default_rng(seed), board_shape=BOARD)
    v, gt = tsyn.render_board_view(
        H, out_size=(480, 640), board_shape=BOARD, noise=noise, seed=view_seed, **kw
    )
    return v.astype(np.uint8), gt


@pytest.fixture(scope="module")
def views():
    """4 clean (bench seeds), 2 HARD_KW, 12 and 16 px motion blur."""
    out = [_render(k, k, 1.5) for k in range(4)]
    out += [_render(100 + k, k, 2.0, **HARD_KW) for k in range(2)]
    out += [_render(300, 0, 2.0, motion_blur_px=b) for b in (12, 16)]
    return np.stack([v for v, _ in out]), np.stack([g for _, g in out])


def _assert_same_detections(got, ref, label=""):
    assert sorted(got) == sorted(ref), f"{label} accepted {sorted(got)} vs {sorted(ref)}"
    for i in ref:
        np.testing.assert_allclose(np.asarray(got[i][0], float), np.asarray(ref[i][0], float),
                                   atol=0.01, err_msg=f"{label} frame {i}")
        np.testing.assert_allclose(np.asarray(got[i][1], float), np.asarray(ref[i][1], float),
                                   atol=1e-3, err_msg=f"{label} frame {i}")


def test_detect_chessboard_batch_matches_jax(views):
    frames, gts = views
    ref = jdet.detect_chessboard_batch(list(frames), board_shape=BOARD)
    got = tmct.detect_chessboard_batch(list(frames), board_shape=BOARD, device="cpu")
    assert len(ref) == len(frames)  # all 8 are detected by JAX
    _assert_same_detections(got, ref)
    for i, (uvs, _) in got.items():  # corner 0 is the anchor-side gt corner
        assert np.linalg.norm(uvs[0] - gts[i][0]) < 2.0
    single = tmct.detect_chessboard(frames[4], board_shape=BOARD, device="cpu")
    ref1 = jdet.detect_chessboard(frames[4], board_shape=BOARD)
    _assert_same_detections({0: single}, {0: ref1}, "B=1")
    # reorder=False returns the first valid window's corners alone.
    plain = tmct.detect_chessboard_batch([frames[4]], board_shape=BOARD, reorder=False,
                                         device="cpu")
    ref_plain = jdet.detect_chessboard_batch([frames[4]], board_shape=BOARD, reorder=False)
    assert sorted(plain) == sorted(ref_plain)
    for i in plain:
        np.testing.assert_allclose(plain[i], ref_plain[i], atol=0.01)


def test_entry_points_refuse_what_is_not_ported(views, monkeypatch):
    """Every option of the JAX package is ported now: what is refused is an
    unknown keyword argument, and the CUDA default without a card, on every
    route (full resolution, low band, scale_factor, streamed)."""
    frames, _ = views
    one = [frames[0]]
    with pytest.raises(TypeError, match="flags"):
        tmct.detect_chessboard_batch(one, board_shape=BOARD, flags=3, device="cpu")
    assert tmct.detect_chessboard_batch([], board_shape=BOARD, device="cpu") == {}
    assert tmct.detect_chessboard_batch([], board_shape=BOARD, coarse_downscale=2,
                                        device="cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"coarse_downscale": 2}, {"scale_factor": 0.5}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmct.detect_chessboard_batch(one, board_shape=BOARD, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tmct.detect_chessboard_batches([one], board_shape=BOARD, **kw))
    for kw in ({}, {"scale_factor": 0.5}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmct.detect_chessboard(frames[0], board_shape=BOARD, **kw)


def test_stored_jax_answers_match_port_cpu_run():
    """data/detect_frames.npz (scripts/export_torch_detect_frames.py) holds
    JAX's answers on its frames; the port's CPU run agrees with them."""
    d = np.load(DETECT_FRAMES)
    frames = d["frames"]
    assert frames.dtype == np.uint8 and frames.shape[1:] == (480, 640)
    assert len(frames) <= 16 and os.path.getsize(DETECT_FRAMES) <= 3 << 20
    board = tuple(int(v) for v in d["board_shape"])
    got = tmct.detect_chessboard_batch(list(frames), board_shape=board, device="cpu")
    ref = {int(i): (d["uvs"][j], d["scores"][j])
           for j, i in enumerate(np.nonzero(d["accepted"])[0])}
    _assert_same_detections(got, ref, "stored")
    xy, sc = tdet.find_corner_candidates(
        tdet._gray_from_u8(torch.as_tensor(frames)) / 255.0, d["cand_xy"].shape[1], 4
    )
    # JAX's stage-1 candidates (the SAME-convolution path on the CPU): every
    # candidate above the ordering's score cut (0.35 x the n-th score) is at
    # the same slot and position; the weak tail holds near-tied noise peaks
    # whose order f32 rounding may swap.
    n = board[0] * board[1]
    strong = d["cand_score"] > 0.35 * d["cand_score"][:, n - 1 : n]
    np.testing.assert_array_equal(xy.numpy()[strong], d["cand_xy"][strong])
    g = tdet._gray_from_u8(torch.as_tensor(frames)) / 255.0
    scale = float(tmct.corner_response(g, impl="conv").abs().max())
    np.testing.assert_allclose(sc.numpy()[strong], d["cand_score"][strong], atol=3e-6 * scale)
