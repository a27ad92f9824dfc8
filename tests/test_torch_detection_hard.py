"""Detection on the JAX package's hard-frame set: PyTorch port vs JAX, CPU.

The 16 views of tests/test_detection.py's hard-frame test (seeds 100-115:
lens distortion, lighting gradient, vignette, clutter) go through both
``detect_chessboard_batch``s. Together they drive every host path of the
batch pipeline, which the test checks ran: the host fallback ordering,
hole settling, the repair pass, the coarse sigma ladder, the occlusion
escalation (frame 8) and the normalized-anchor rescue (frame 6). The port
must make JAX's decisions: the same accepted frames, corners within 0.01 px
(hence the same orientation), sorted anchor scores within 1e-3.
"""
import collections

import numpy as np

from multicam_calibration_tpu.detection import detector as jdet
from multicam_calibration_tpu_torch.detection import detector as tdet
from multicam_calibration_tpu_torch.detection import synthetic_images as tsyn

BOARD = (5, 7)
K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=np.array([-0.28, 0.12]), lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)


def test_hard_frames_match_jax_through_every_host_path(monkeypatch):
    frames = []
    for k in range(16):
        H = tsyn.random_view_homography(np.random.default_rng(100 + k), board_shape=BOARD)
        v, _ = tsyn.render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=2.0, seed=k, **HARD_KW
        )
        frames.append(v.astype(np.uint8))
    calls = collections.Counter()

    def spy(name):
        fn = getattr(tdet, name)

        def wrapped(*a, **kw):
            calls[name + ("+escalated" if kw.get("max_holes") else "")] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(tdet, name, wrapped)

    for name in ("order_grid_points", "_settle_constructed", "_repair_grid",
                 "_coarse_retry_impl", "_anchor_scores_normalized_at"):
        spy(name)
    got = tdet.detect_chessboard_batch(frames, board_shape=BOARD, device="cpu")
    for name in ("order_grid_points", "_settle_constructed", "_repair_grid",
                 "_coarse_retry_impl", "order_grid_points+escalated",
                 "_anchor_scores_normalized_at"):
        assert calls[name] > 0, f"{name} did not run: {dict(calls)}"
    ref = jdet.detect_chessboard_batch(frames, board_shape=BOARD)
    assert len(ref) >= 10  # tests/test_detection.py's bar for the JAX package
    assert sorted(got) == sorted(ref)
    for i in ref:
        np.testing.assert_allclose(got[i][0], ref[i][0], atol=0.01, err_msg=f"frame {i}")
        np.testing.assert_allclose(got[i][1], ref[i][1], atol=1e-3, err_msg=f"frame {i}")
