"""The port's native lattice growth (``csrc/lattice.cc``) against its numpy twin, CPU.

``detection/native_lattice.py`` binds the C++ copy of the JAX package's
``native/src/lattice.cc``, built with the host compiler at first use. The
bounds are the JAX package's (tests/test_native_lattice.py): native and
numpy growth keep the same candidates and pitch and choose the same corner
set, with the lattice equal up to one of the 8 flip/transpose coordinate
symmetries (a near-tie in a neighbour-distance sort can mirror the frame),
and ``detect_chessboard_batch`` gives the same detections within 1e-5 on
either route. Also: the port's native growth equals the JAX package's
numpy growth on the same candidates, the routing follows the JAX package's
(native at rung 0 with the default hole budget, numpy otherwise and under
``MCC_NO_NATIVE_LATTICE``), and a failed build raises. The symmetry check
is chip_smoke phase 15's own.
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import lattice_up_to_symmetry
from multicam_calibration_tpu.detection import detector as jdet
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import detector as tdet
from multicam_calibration_tpu_torch.detection import native_lattice
from multicam_calibration_tpu_torch.detection import synthetic_images as tsyn
from multicam_calibration_tpu_torch.ops import _build
from tests.test_torch_detection_lowband import BOARD, HARD_KW, K_TEST, _views

N_NEEDED = BOARD[0] * BOARD[1]
DETECT_FRAMES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "multicam_calibration_tpu_torch", "data", "detect_frames.npz")


def _candidates(frames):
    """The port's stage-1 candidates (f64 numpy), as the host ordering gets them."""
    g = tdet._gray_from_u8(torch.as_tensor(np.stack(frames))) / 255.0
    xy, sc = tdet.find_corner_candidates(g, 160, 4)
    return xy.numpy().astype(float), sc.numpy().astype(float)


def _assert_same_growth(rn, rp):
    np.testing.assert_array_equal(rn[0], rp[0])
    np.testing.assert_array_equal(rn[1], rp[1])
    assert rn[2] == pytest.approx(rp[2], abs=1e-9)
    assert (rn[3] is None) == (rp[3] is None)
    if rn[3] is not None:
        assert set(rn[3].values()) == set(rp[3].values())
        assert lattice_up_to_symmetry(rn[3], rp[3])


@pytest.mark.parametrize(
    "kw", [{}, dict(camera_matrix=K_TEST, dist_coefs=HARD_KW["dist_coefs"]), HARD_KW],
    ids=["clean", "distorted", "hard"],
)
def test_native_matches_numpy_growth(kw):
    """tests/test_native_lattice.py's corpus (8 seeds per kind), on the port's
    candidates: the port's native growth against its numpy twin and against
    the JAX package's numpy growth."""
    frames = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        H = tsyn.random_view_homography(rng, board_shape=BOARD)
        v, _ = tsyn.render_board_view(
            H, out_size=(480, 640), board_shape=BOARD, noise=1.5, seed=seed, **kw)
        frames.append(v.astype(np.uint8))
    pts, sc = _candidates(frames)
    n_grids = 0
    for p, s in zip(pts, sc):
        rn = native_lattice.grow_lattice(p, s, N_NEEDED, 0.35)
        _assert_same_growth(rn, tdet._grow_lattice_numpy(p, s, N_NEEDED, 0.35))
        _assert_same_growth(rn, jdet._grow_lattice_numpy(p, s, N_NEEDED, 0.35))
        n_grids += rn[3] is not None
    assert n_grids >= 6  # the corpus exercises growth


def test_native_matches_numpy_on_stored_candidates():
    """JAX's stage-1 candidates of data/detect_frames.npz (what chip_smoke
    phase 15 grows on the card's host)."""
    d = np.load(DETECT_FRAMES)
    n_grids = 0
    for p, s in zip(d["cand_xy"].astype(float), d["cand_score"].astype(float)):
        rn = native_lattice.grow_lattice(p, s, N_NEEDED, 0.35)
        _assert_same_growth(rn, tdet._grow_lattice_numpy(p, s, N_NEEDED, 0.35))
        n_grids += rn[3] is not None
    assert n_grids >= 12  # all but the blurred frames grow at sigma 1.5


def test_no_grid_on_clutter_and_too_few_points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 640, size=(60, 2))
    sc = rng.uniform(0.5, 1.0, size=60)
    rn = native_lattice.grow_lattice(pts, sc, N_NEEDED, 0.35)
    assert (rn[3] is None) == (tdet._grow_lattice_numpy(pts, sc, N_NEEDED, 0.35)[3] is None)
    assert native_lattice.grow_lattice(pts[:10], sc[:10], N_NEEDED, 0.35)[3] is None


def test_routing_follows_the_jax_package(monkeypatch):
    """Native at rung 0 with the default hole budget; numpy for an upper
    rung, an escalated budget, or MCC_NO_NATIVE_LATTICE."""
    pts, sc = _candidates(_views(1, 3100))
    calls = []
    real = native_lattice.grow_lattice
    monkeypatch.setattr(native_lattice, "grow_lattice",
                        lambda *a: calls.append("native") or real(*a))
    tdet._grow_lattice(pts[0], sc[0], N_NEEDED, 0.35)
    tdet._grow_lattice(pts[0], sc[0], N_NEEDED, 0.35, max_holes=tdet._HOLE_TOLERANCE)
    assert calls == ["native", "native"]
    tdet._grow_lattice(pts[0], sc[0], N_NEEDED, 0.35, rung=1)
    tdet._grow_lattice(pts[0], sc[0], N_NEEDED, 0.35, max_holes=5)
    monkeypatch.setenv(native_lattice.DISABLE_ENV, "1")
    tdet._grow_lattice(pts[0], sc[0], N_NEEDED, 0.35)
    assert calls == ["native", "native"]


def test_detections_agree_on_either_route(monkeypatch):
    """The hard frames (host fallback ordering) through
    ``detect_chessboard_batch`` with the native growth and with numpy."""
    frames = _views(4, 3200, **HARD_KW)
    native = tmct.detect_chessboard_batch(frames, board_shape=BOARD, device="cpu")
    monkeypatch.setenv(native_lattice.DISABLE_ENV, "1")
    numpy_route = tmct.detect_chessboard_batch(frames, board_shape=BOARD, device="cpu")
    assert sorted(native) == sorted(numpy_route) and len(native) >= 3
    for i in native:
        np.testing.assert_allclose(native[i][0], numpy_route[i][0], atol=1e-5)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the first growth raises instead of falling back to numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_host_cxx", lambda: "false")  # exits 1
    _build.load_host_library.cache_clear()
    native_lattice._fn.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build lattice.cc"):
            tdet._grow_lattice(np.zeros((40, 2)), np.ones(40), N_NEEDED, 0.35)
    finally:
        _build.load_host_library.cache_clear()
        native_lattice._fn.cache_clear()
    assert not list(tmp_path.glob("*.so"))
