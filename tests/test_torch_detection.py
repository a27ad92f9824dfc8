"""Chessboard detection, PyTorch port vs the JAX package, on the CPU.

The same rendered 480x640 views (``synthetic_images``, numpy + cv2) go
through each stage of both packages:

- homographies: ``fit_homography`` (eigh and solve), ``apply_homography``,
  ``inv3x3``, ``warp_perspective`` in f64, at 1e-9;
- ``find_corner_candidates``: the same positions as the JAX candidates
  through the Pallas kernel (interpret mode), scores within 3e-6 x the
  largest |response| (tests/test_pallas_kernels.py's tolerance);
- ``refine_corners_subpix`` from the same seeds: within 1e-4 px (f32 sums
  in other orders);
- ``_order_grids_device`` on the same candidates: the same ``ok`` and the
  same grids;
- ``_batched_anchor_scores`` on the same grids: within 1e-4 (f32 sums of
  1600 products in other orders);
- ``extend_grid`` (f64) and ``reorder_chessboard_corners`` on the ground
  truth: the same flips, scores within 1e-4;
- the ``scale_factor`` path: the resize against ``jax.image.resize`` within
  1e-4, and ``detect_chessboard`` at scale 0.5, 0.75 and 1.5 on a clean, a
  hard and a blurred view with JAX's decisions, corners within 0.01 px;
- the copied numpy host code (``order_grid_points``) and
  ``synthetic_images``: bit-identical.

The whole pipeline is in tests/test_torch_detection_batch.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multicam_calibration_tpu.detection import detector as jdet
from multicam_calibration_tpu.detection import synthetic_images as jsyn
from multicam_calibration_tpu.ops import homography as jhom
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import detector as tdet
from multicam_calibration_tpu_torch.detection import synthetic_images as tsyn
from multicam_calibration_tpu_torch.ops import homography as thom

BOARD = (5, 7)
K_TEST = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
HARD_KW = dict(
    camera_matrix=K_TEST, dist_coefs=np.array([-0.28, 0.12]), lighting_gradient=0.8,
    vignette=0.4, clutter=6,
)


def _render(syn, seed, view_seed, noise, **kw):
    rng = np.random.default_rng(seed)
    H = syn.random_view_homography(rng, board_shape=BOARD)
    v, gt = syn.render_board_view(
        H, out_size=(480, 640), board_shape=BOARD, noise=noise, seed=view_seed, **kw
    )
    return v.astype(np.uint8), gt


@pytest.fixture(scope="module")
def views():
    """4 clean (bench seeds), 2 HARD_KW, 12 and 16 px motion blur."""
    out = [_render(tsyn, k, k, 1.5) for k in range(4)]
    out += [_render(tsyn, 100 + k, k, 2.0, **HARD_KW) for k in range(2)]
    out += [_render(tsyn, 300, 0, 2.0, motion_blur_px=b) for b in (12, 16)]
    return np.stack([v for v, _ in out]), np.stack([g for _, g in out])


@pytest.fixture(scope="module")
def jax_stage1(views):
    """JAX candidates through the Pallas kernel (interpret mode)."""
    frames, _ = views
    gray = jdet._gray_from_u8(jnp.asarray(frames))
    xy, sc = jdet.find_corner_candidates(gray / 255.0, 160, 4, use_pallas=True)
    return np.array(gray), np.array(xy), np.array(sc)


def test_synthetic_images_copy_is_bit_identical():
    for kw in ({}, HARD_KW, dict(motion_blur_px=12), dict(occlusion_px=20, specular=2,
                                                          background_texture=0.5)):
        for syn_seed in (3, 104):
            vj, gj = _render(jsyn, syn_seed, 1, 2.0, **kw)
            vt, gt = _render(tsyn, syn_seed, 1, 2.0, **kw)
            np.testing.assert_array_equal(vt, vj)
            np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("method", ["eigh", "solve"])
def test_fit_homography_matches_jax(method):
    rng = np.random.default_rng(5)
    src = rng.uniform(-50, 50, (6, 20, 2))
    Htrue = np.eye(3) + rng.normal(0, [[0.1, 0.1, 5], [0.1, 0.1, 5], [1e-4, 1e-4, 0]], (6, 3, 3))
    ph = np.concatenate([src, np.ones((6, 20, 1))], -1) @ np.swapaxes(Htrue, -1, -2)
    dst = ph[..., :2] / ph[..., 2:] + rng.normal(0, 0.1, (6, 20, 2))
    w = (rng.random((6, 20)) > 0.2).astype(float)
    for weights in (None, w):
        hj = np.array(jhom.fit_homography(
            jnp.asarray(src), jnp.asarray(dst),
            None if weights is None else jnp.asarray(weights), method=method,
        ))
        ht = thom.fit_homography(
            torch.as_tensor(src), torch.as_tensor(dst),
            None if weights is None else torch.as_tensor(weights), method=method,
        ).numpy()
        np.testing.assert_allclose(ht, hj, rtol=1e-9, atol=1e-9)
    pts = rng.uniform(0, 100, (6, 9, 2))
    np.testing.assert_allclose(
        thom.apply_homography(torch.as_tensor(hj), torch.as_tensor(pts)).numpy(),
        np.asarray(jhom.apply_homography(jnp.asarray(hj), jnp.asarray(pts))),
        rtol=1e-12, atol=1e-9,
    )
    np.testing.assert_allclose(
        thom.inv3x3(torch.as_tensor(hj)).numpy(), np.asarray(jhom.inv3x3(jnp.asarray(hj))),
        rtol=1e-10, atol=1e-12,
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_inverse_iteration_fit_matches_jax_eigh(dtype):
    """``method="inverse"`` (the eigh DLT without a host sync) against the
    JAX package's eigh fit: rtol 1e-9 in f64; in f32, 1e-4 of each entry's
    scale, as the other f32 homography comparisons of this file."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-50, 50, (6, 9, 2))
    Htrue = np.eye(3) + rng.normal(0, [[0.1, 0.1, 5], [0.1, 0.1, 5], [1e-4, 1e-4, 0]], (6, 3, 3))
    ph = np.concatenate([src, np.ones((6, 9, 1))], -1) @ np.swapaxes(Htrue, -1, -2)
    dst = ph[..., :2] / ph[..., 2:] + rng.normal(0, 0.1, (6, 9, 2))
    hj = np.array(jhom.fit_homography(jnp.asarray(src), jnp.asarray(dst)))
    ht = thom.fit_homography(torch.as_tensor(src, dtype=dtype), torch.as_tensor(dst, dtype=dtype),
                             method="inverse").double().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(ht, hj, rtol=1e-9, atol=1e-9)
    else:
        np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4 * np.abs(hj).max())


def test_solve_fit_of_singular_system_is_nan_not_an_error():
    src = torch.zeros((2, 6, 2), dtype=torch.float64)
    H = thom.fit_homography(src, src, weights=torch.zeros((2, 6), dtype=torch.float64),
                            method="solve")
    assert torch.isnan(H).all()


def test_warp_perspective_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (40, 50))
    H = np.array([[1.1, 0.05, -3.0], [-0.04, 0.95, 2.0], [1e-4, -2e-4, 1.0]])
    np.testing.assert_allclose(
        thom.warp_perspective(torch.as_tensor(img), torch.as_tensor(H), (30, 45)).numpy(),
        np.asarray(jhom.warp_perspective(jnp.asarray(img), jnp.asarray(H), (30, 45))),
        rtol=1e-10, atol=1e-8,
    )


def test_find_corner_candidates_matches_jax(views, jax_stage1):
    gray, xy_j, sc_j = jax_stage1
    g = torch.as_tensor(gray) / 255.0
    xy_t, sc_t = tdet.find_corner_candidates(g, 160, 4)
    np.testing.assert_array_equal(xy_t.numpy(), xy_j)
    scale = float(np.abs(np.asarray(jdet.corner_response(jnp.asarray(g.numpy()),
                                                         use_pallas=False))).max())
    np.testing.assert_allclose(sc_t.numpy(), sc_j, atol=3e-6 * scale)
    # tie order: the all-zero tail is in tile-index order, as lax.top_k.
    z = torch.zeros((1, 40, 40))
    xy0, sc0 = tdet.find_corner_candidates(z, 5, 4)
    assert sc0.abs().max() == 0
    np.testing.assert_array_equal(xy0[0].numpy(), [[0, 0], [4, 0], [8, 0], [12, 0], [16, 0]])


def test_refine_corners_subpix_matches_jax(views, jax_stage1):
    """Seeds near the board corners, where refinement is well conditioned.
    The motion-blur views are refined at the coarse ladder's windows only,
    as the pipeline does: at win 5 their fixed point lands ~1.3 px off the
    truth and amplifies f32 rounding past 1e-4 px."""
    gray = jax_stage1[0]
    g = gray / np.float32(255.0)
    seeds = (np.round(views[1]) + 0.3).astype(np.float32)
    sharp = slice(0, 6)
    for win, drift, sel in ((5, 3.0, sharp), (5, 1.0, sharp), (11, 3.0, slice(None)),
                            (17, 3.0, slice(6, None))):
        rj = np.asarray(jdet.refine_corners_subpix(
            jnp.asarray(g[sel]), jnp.asarray(seeds[sel]), win_size=win, max_drift=drift
        ))
        rt = tdet.refine_corners_subpix(
            torch.as_tensor(g[sel]), torch.as_tensor(seeds[sel]), win_size=win, max_drift=drift
        ).numpy()
        np.testing.assert_allclose(rt, rj, atol=1e-4)


@pytest.mark.parametrize("min_sep", [0.0, 5.0])
def test_order_grids_device_matches_jax(jax_stage1, min_sep):
    _, xy_j, sc_j = jax_stage1
    rows, cols = BOARD
    uv_j, ok_j = jdet._order_grids_device(
        jnp.asarray(xy_j), jnp.asarray(sc_j), rows, cols, min_candidate_sep=min_sep
    )
    uv_t, ok_t = tdet._order_grids_device(
        torch.as_tensor(xy_j), torch.as_tensor(sc_j), rows, cols, min_candidate_sep=min_sep
    )
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t[:4].all()  # the clean frames certify
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    # A cloud with no board never certifies; fewer slots than corners defer.
    rng = np.random.default_rng(0)
    xy_r = rng.uniform(20, 600, (8, 160, 2)).astype(np.float32)
    sc_r = np.sort(rng.uniform(0.1, 1.0, (8, 160)).astype(np.float32), axis=1)[:, ::-1].copy()
    _, ok_r = tdet._order_grids_device(torch.as_tensor(xy_r), torch.as_tensor(sc_r), rows, cols)
    assert not ok_r.any()
    _, ok_s = tdet._order_grids_device(torch.as_tensor(xy_r[:, :20]),
                                       torch.as_tensor(sc_r[:, :20]), rows, cols)
    assert not ok_s.any()


def test_batched_anchor_scores_match_jax(views, jax_stage1):
    gray, xy_j, sc_j = jax_stage1
    rows, cols = BOARD
    uv_j, _ = jdet._order_grids_device(jnp.asarray(xy_j), jnp.asarray(sc_j), rows, cols)
    grids = np.asarray(uv_j) + np.float32(0.25)
    sj = np.asarray(jdet._batched_anchor_scores(jnp.asarray(gray), jnp.asarray(grids)))
    st = tdet._batched_anchor_scores(torch.as_tensor(gray), torch.as_tensor(grids)).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-4)
    nj = np.asarray(jdet._anchor_scores_normalized_at(
        jnp.asarray(gray), jnp.asarray([5, 1]), jnp.asarray(grids[[5, 1]]), 40
    ))
    nt = tdet._anchor_scores_normalized_at(
        torch.as_tensor(gray), torch.as_tensor([5, 1]), torch.as_tensor(grids[[5, 1]]), 40
    ).numpy()
    np.testing.assert_allclose(nt, nj, atol=1e-3)


def test_order_grid_points_copy_is_bit_identical(jax_stage1):
    _, xy_j, sc_j = jax_stage1
    for i in range(len(xy_j)):
        for kw in (dict(), dict(n_windows=6, return_masks=True),
                   dict(n_windows=6, return_masks=True, max_holes=5)):
            a = jdet.order_grid_points(xy_j[i], sc_j[i], BOARD, refined=False, **kw)
            b = tdet.order_grid_points(xy_j[i], sc_j[i], BOARD, refined=False, **kw)
            if a is None or b is None:
                assert a is None and b is None
                continue
            if kw:
                assert len(a) == len(b)
                for (ua, ma), (ub, mb) in zip(a, b):
                    np.testing.assert_array_equal(ub, ua)
                    np.testing.assert_array_equal(mb, ma)
            else:
                np.testing.assert_array_equal(b, a)


def test_extend_grid_and_reorder_match_jax(views, jax_stage1):
    frames, gts = views
    grid = gts[0].reshape(BOARD[1], BOARD[0], 2)
    ej = np.asarray(jdet.extend_grid(jnp.asarray(grid), 3, 1))
    et = tdet.extend_grid(torch.as_tensor(grid), 3, 1).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-8)
    for i in (0, 4):
        uj, sj, (extj, msj) = jdet.reorder_chessboard_corners(frames[i], gts[i], BOARD)
        ut, st, (extt, mst) = tdet.reorder_chessboard_corners(
            frames[i], gts[i], BOARD, device="cpu"
        )
        np.testing.assert_array_equal(ut, uj)  # same flips of the same input
        np.testing.assert_allclose(st, sj, atol=1e-4)
        np.testing.assert_allclose(mst, msj, atol=1e-4)
        np.testing.assert_allclose(extt, np.asarray(extj), atol=1e-3)


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.5])
def test_resize_matches_jax_image_resize(views, scale):
    """``_resize_bilinear`` against ``jax.image.resize(..., "bilinear")`` on a
    0-255 gray (antialiased when it shrinks): within 1e-4 (f32 products
    summed in other orders)."""
    import jax

    gray = jdet._to_gray_f(views[0][4])
    shape = (int(round(480 * scale)), int(round(640 * scale)))
    ref = np.asarray(jax.image.resize(gray, shape, method="bilinear"))
    got = tdet._resize_bilinear(torch.as_tensor(np.asarray(gray)), shape).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.5])
def test_detect_chessboard_at_scale_factor_matches_jax(views, scale):
    """The single-frame ``scale_factor`` path on a clean, a hard and a
    blurred view: JAX's decisions, corners within 0.01 px, sorted anchor
    scores within 1e-3; ``detect_chessboard_batch`` routes each frame
    through it."""
    frames, _ = views
    picked = [frames[0], frames[4], frames[6]]
    ref = {}
    for i, fr in enumerate(picked):
        r = jdet.detect_chessboard(fr, board_shape=BOARD, scale_factor=scale)
        if r is not None:
            ref[i] = r
    got = tmct.detect_chessboard_batch(picked, board_shape=BOARD, scale_factor=scale,
                                       device="cpu")
    assert 0 in ref  # the clean view is detected at every scale
    assert sorted(got) == sorted(ref)
    for i in ref:
        np.testing.assert_allclose(got[i][0], np.asarray(ref[i][0], float), atol=0.01)
        np.testing.assert_allclose(got[i][1], np.asarray(ref[i][1], float), atol=1e-3)
    one = tmct.detect_chessboard(picked[0], board_shape=BOARD, scale_factor=scale,
                                 reorder=False, device="cpu")
    one_ref = jdet.detect_chessboard(picked[0], board_shape=BOARD, scale_factor=scale,
                                     reorder=False)
    np.testing.assert_allclose(one, np.asarray(one_ref, float), atol=0.01)
