"""Synthetic chessboard image rendering — the detection test oracle.

Renders the reference's physical target (two-sided checkerboard with a dark
anchor circle near the top-left corner, docs/source/setup.rst) under
arbitrary homographies, with ground-truth corner positions. Used to test
the detector's detection rate and subpixel accuracy without video
fixtures (the reference snapshot ships none — SURVEY.md §4).

A numpy copy of ``multicam_calibration_tpu/detection/synthetic_images.py``
(importing that module imports JAX through its package); the renders are
bit-identical (tests/test_torch_detection.py). ``cv2`` is imported inside
the functions that use it, so importing this module needs no OpenCV.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "render_board_image",
    "render_board_view",
    "random_view_homography",
    "distort_pixels",
    "undistort_pixel_map",
    "degrade_view",
]


def random_view_homography(
    rng, out_size=(480, 640), board_shape=(5, 7), square_px=40,
    margin_squares=2, scale_range=(0.45, 0.8), perspective=2e-4,
):
    """Random homography that keeps the (canonical) board centered in view.

    Rotation is uniform in [0, 2pi); scale anisotropy and mild projective
    terms model tilt. The canonical-board center maps to the view center.
    """
    rows, cols = board_shape
    can_h = (rows + 1 + 2 * margin_squares) * square_px
    can_w = (cols + 1 + 2 * margin_squares) * square_px
    center = np.array([can_w / 2, can_h / 2])
    ang = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(ang), np.sin(ang)
    A = np.array([[c, -s], [s, c]]) @ np.diag(rng.uniform(*scale_range, 2))
    p = rng.uniform(-1, 1, 2) * perspective
    H = np.eye(3)
    H[:2, :2] = A
    H[2, :2] = p
    # Solve the translation so H maps the board center to the view center.
    out_c = np.array([out_size[1] / 2, out_size[0] / 2])
    w = 1.0 + p @ center
    H[:2, 2] = out_c * w - A @ center
    return H


def render_board_image(
    board_shape=(5, 7), square_px=40, margin_squares=2, anchor=True
):
    """Canonical fronto-parallel board image + ground-truth corner coords.

    Returns (image (H, W) float in [0, 255], corners (rows*cols, 2) in
    (x, y) pixel coords, row-major over the (rows, cols) lattice with the
    anchor adjacent to corner 0).
    """
    rows, cols = board_shape
    n_sq_y = rows + 1
    n_sq_x = cols + 1
    m = margin_squares
    H = (n_sq_y + 2 * m) * square_px
    W = (n_sq_x + 2 * m) * square_px
    img = np.full((H, W), 255.0)
    for i in range(n_sq_y):
        for j in range(n_sq_x):
            if (i + j) % 2 == 0:
                y0 = (m + i) * square_px
                x0 = (m + j) * square_px
                img[y0 : y0 + square_px, x0 : x0 + square_px] = 0.0
    # Interior corners: (rows x cols) lattice, ordered rows-fastest to match
    # generate_chessboard_objpoints / the detector's uvs convention
    # (consecutive points step along the rows axis; uvs.reshape(cols, rows)
    # recovers the lattice).
    ys = (m + 1 + np.arange(rows)) * square_px
    xs = (m + 1 + np.arange(cols)) * square_px
    corners = np.stack(
        [np.repeat(xs, rows), np.tile(ys, cols)], axis=-1
    ).astype(float)
    if anchor:
        # Dark circle at the position the reference's anchor matcher probes:
        # extended-grid cell (0.5, 0.5) with the grid starting at (3, 1),
        # i.e. 2.5 lattice steps beyond corner 0 along the cols axis (x) and
        # 0.5 steps before it along the rows axis (y); radius = half a cell
        # (the 40x40 template's size//4 circle, detection.py:408-412).
        cy = ys[0] - 0.5 * square_px
        cx = xs[0] - 2.5 * square_px
        yy, xx = np.mgrid[0:H, 0:W]
        circle = (yy - cy) ** 2 + (xx - cx) ** 2 <= (0.5 * square_px) ** 2
        img[circle] = 0.0
    return img, corners


def distort_pixels(uv, camera_matrix, dist_coefs):
    """Ideal (pinhole) pixel coords -> distorted pixel coords.

    The reference's radial model (geometry.py:277-325): normalize with K,
    scale x,y by 1 + k1 r^2 + k2 r^4, re-project with K.
    """
    K = np.asarray(camera_matrix, float)
    d = np.asarray(dist_coefs, float).ravel()
    k1 = d[0] if d.size > 0 else 0.0
    k2 = d[1] if d.size > 1 else 0.0
    xy = (np.asarray(uv, float) - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    r2 = np.sum(xy**2, axis=-1, keepdims=True)
    xy_d = xy * (1.0 + k1 * r2 + k2 * r2**2)
    return xy_d * np.array([K[0, 0], K[1, 1]]) + K[:2, 2]


def undistort_pixel_map(out_size, camera_matrix, dist_coefs, n_iters=10):
    """Per-output-pixel map: distorted pixel -> ideal (pinhole) pixel.

    Fixed-point inversion of the radial model (the same iteration as
    ops.projection.undistort_normalized, in numpy for host rendering).
    Returns (h, w, 2) float32 ideal-pixel coordinates — the cv2.remap
    source map for rendering what a distorted lens actually sees.
    """
    K = np.asarray(camera_matrix, float)
    d = np.asarray(dist_coefs, float).ravel()
    k1 = d[0] if d.size > 0 else 0.0
    k2 = d[1] if d.size > 1 else 0.0
    h, w = out_size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xd = (xs - K[0, 2]) / K[0, 0]
    yd = (ys - K[1, 2]) / K[1, 1]
    xu, yu = xd.copy(), yd.copy()
    for _ in range(n_iters):
        r2 = xu**2 + yu**2
        scale = 1.0 + k1 * r2 + k2 * r2**2
        xu = xd / scale
        yu = yd / scale
    return np.stack(
        [xu * K[0, 0] + K[0, 2], yu * K[1, 1] + K[1, 2]], axis=-1
    ).astype(np.float32)


def degrade_view(
    view,
    rng,
    lighting_gradient=0.0,
    vignette=0.0,
    clutter=0,
    occlusion_px=0,
    occlusion_bars=1,
    motion_blur_px=0,
    board_region=None,
    background_texture=0.0,
    specular=0,
):
    """Apply realistic nuisance factors to a rendered view, in place order:
    background texture -> clutter shapes -> occlusion bar(s) -> specular
    highlights -> lighting gradient -> vignette -> motion blur.
    ``board_region`` ((x0, y0), (x1, y1)) aims the occlusion bars and
    specular glare at the board; clutter and texture land outside it.
    ``occlusion_bars`` crosses that many independent bars of width
    ``occlusion_px`` through the board (cables / limbs). ``specular`` adds
    that many saturating gaussian glare blobs near the board edge (the
    lighting artifact real calibration videos have from glossy boards).
    ``background_texture`` in [0, 1] blends a smooth random texture into
    the non-board background (cv2's quad detector must cope with textured
    scenes; ours must too).
    """
    import cv2

    view = np.asarray(view, float).copy()
    h, w = view.shape[:2]
    if background_texture > 0:
        g = rng.uniform(0, 255, (h // 16 + 2, w // 16 + 2))
        tex = cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)
        m = np.ones((h, w))
        if board_region is not None:
            (bx0, by0), (bx1, by1) = board_region
            pad = 6  # keep the board's own quiet margin
            m[
                max(int(by0) - pad, 0) : min(int(by1) + pad, h),
                max(int(bx0) - pad, 0) : min(int(bx1) + pad, w),
            ] = 0.0
        a = background_texture * m
        view = view * (1.0 - a) + tex * a
    for _ in range(int(clutter)):
        shade = float(rng.uniform(0, 255))
        kind = rng.integers(0, 3)
        cx, cy = int(rng.uniform(0, w)), int(rng.uniform(0, h))
        if board_region is not None:
            (bx0, by0), (bx1, by1) = board_region
            # Keep clutter centers off the board so detection-rate tests
            # separate "busy scene" from "occluded target".
            for _ in range(10):
                if not (bx0 <= cx <= bx1 and by0 <= cy <= by1):
                    break
                cx, cy = int(rng.uniform(0, w)), int(rng.uniform(0, h))
        size = int(rng.uniform(10, 60))
        if kind == 0:
            cv2.rectangle(
                view, (cx - size, cy - size), (cx + size, cy + size),
                shade, -1,
            )
        elif kind == 1:
            cv2.circle(view, (cx, cy), size, shade, -1)
        else:
            ang = rng.uniform(0, np.pi)
            dx, dy = int(np.cos(ang) * size * 3), int(np.sin(ang) * size * 3)
            cv2.line(
                view, (cx - dx, cy - dy), (cx + dx, cy + dy), shade,
                int(rng.uniform(2, 8)),
            )
    if occlusion_px > 0:
        # Bar(s) across the board (cable / limb in frame). Each bar gets
        # its own angle, shade, and a small offset from the board center.
        if board_region is not None:
            (bx0, by0), (bx1, by1) = board_region
            cx0, cy0 = (bx0 + bx1) / 2, (by0 + by1) / 2
            span = max(bx1 - bx0, by1 - by0)
        else:
            cx0, cy0 = w / 2, h / 2
            span = min(w, h) / 2
        for _ in range(int(occlusion_bars)):
            cx = cx0 + rng.uniform(-0.25, 0.25) * span
            cy = cy0 + rng.uniform(-0.25, 0.25) * span
            ang = rng.uniform(0, np.pi)
            dx, dy = np.cos(ang) * w, np.sin(ang) * w
            cv2.line(
                view,
                (int(cx - dx), int(cy - dy)),
                (int(cx + dx), int(cy + dy)),
                float(rng.uniform(0, 255)),
                int(occlusion_px),
            )
    if specular > 0:
        # Saturating glare blobs near the board edge (glossy board /
        # overhead lights). Additive, clipped at the end like everything.
        if board_region is not None:
            (bx0, by0), (bx1, by1) = board_region
        else:
            (bx0, by0), (bx1, by1) = (w * 0.25, h * 0.25), (w * 0.75, h * 0.75)
        ys, xs = np.mgrid[0:h, 0:w]
        for _ in range(int(specular)):
            # Uniform on the board's bounding box edge band.
            t = rng.uniform(0, 1)
            if rng.uniform() < 0.5:
                cx = bx0 + t * (bx1 - bx0)
                cy = by0 if rng.uniform() < 0.5 else by1
            else:
                cx = bx0 if rng.uniform() < 0.5 else bx1
                cy = by0 + t * (by1 - by0)
            sig = rng.uniform(10, 28)
            blob = np.exp(
                -((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sig * sig)
            )
            view = view + 255.0 * blob
    if lighting_gradient > 0:
        gx, gy = rng.uniform(-1, 1, 2) * lighting_gradient
        ys, xs = np.mgrid[0:h, 0:w]
        ramp = 1.0 + gx * (xs / w - 0.5) + gy * (ys / h - 0.5)
        view = view * np.clip(ramp, 0.05, None)
    if vignette > 0:
        ys, xs = np.mgrid[0:h, 0:w]
        r2 = ((xs - w / 2) / (w / 2)) ** 2 + ((ys - h / 2) / (h / 2)) ** 2
        view = view * (1.0 - vignette * r2 / 2.0)
    if motion_blur_px > 1:
        k = np.zeros((motion_blur_px, motion_blur_px))
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        for t in np.linspace(-1, 1, 4 * motion_blur_px):
            x = int(round(motion_blur_px / 2 + t * motion_blur_px / 2 * c))
            y = int(round(motion_blur_px / 2 + t * motion_blur_px / 2 * s))
            if 0 <= x < motion_blur_px and 0 <= y < motion_blur_px:
                k[y, x] = 1.0
        k /= k.sum()
        view = cv2.filter2D(view, -1, k)
    return np.clip(view, 0, 255)


def render_board_view(
    H_board_to_view,
    out_size=(480, 640),
    board_shape=(5, 7),
    square_px=40,
    noise=2.0,
    blur_sigma=1.0,
    seed=0,
    camera_matrix=None,
    dist_coefs=None,
    lighting_gradient=0.0,
    vignette=0.0,
    clutter=0,
    occlusion_px=0,
    occlusion_bars=1,
    motion_blur_px=0,
    background_texture=0.0,
    specular=0,
):
    """Warp the canonical board through a homography into a camera view.

    Returns (view image (h, w) float, gt_corners (rows*cols, 2) in view
    pixel coords). Homography maps canonical-image pixels -> IDEAL (pinhole)
    view pixels; with ``camera_matrix``+``dist_coefs`` set, the view is
    rendered through the radial k1,k2 lens (one fused remap canonical ->
    distorted view) and gt corners are returned in DISTORTED pixel coords —
    i.e. what a real camera would deliver (VERDICT r1: the detector must be
    validated on lens-distorted pixels). The remaining kwargs add lighting
    gradients, clutter, occlusion and motion blur via ``degrade_view``.
    """
    import cv2

    canonical, corners = render_board_image(board_shape, square_px)
    h, w = out_size
    H = np.asarray(H_board_to_view, float)
    distorted = camera_matrix is not None and dist_coefs is not None
    if distorted:
        # Compose: output (distorted) pixel -> ideal pixel -> canonical.
        ideal_map = undistort_pixel_map(out_size, camera_matrix, dist_coefs)
        Hinv = np.linalg.inv(H)
        pts = np.concatenate(
            [ideal_map.reshape(-1, 2), np.ones((h * w, 1), np.float32)], 1
        )
        src = pts @ Hinv.T
        src = (src[:, :2] / src[:, 2:]).reshape(h, w, 2).astype(np.float32)
        view = cv2.remap(
            canonical, src[..., 0], src[..., 1], cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=180.0,
        )
    else:
        view = cv2.warpPerspective(
            canonical, H, (w, h), flags=cv2.INTER_LINEAR, borderValue=180.0,
        )
    pts = np.concatenate([corners, np.ones((len(corners), 1))], axis=1)
    proj = pts @ H.T
    gt = proj[:, :2] / proj[:, 2:]
    if distorted:
        gt = distort_pixels(gt, camera_matrix, dist_coefs)

    rng = np.random.default_rng(seed)
    if (clutter or occlusion_px or lighting_gradient or vignette
            or motion_blur_px or background_texture or specular):
        pad = 0.05 * max(gt.max(0) - gt.min(0))
        board_region = (tuple(gt.min(0) - pad), tuple(gt.max(0) + pad))
        view = degrade_view(
            view, rng,
            lighting_gradient=lighting_gradient, vignette=vignette,
            clutter=clutter, occlusion_px=occlusion_px,
            occlusion_bars=occlusion_bars,
            motion_blur_px=motion_blur_px, board_region=board_region,
            background_texture=background_texture, specular=specular,
        )
    if blur_sigma > 0:
        view = cv2.GaussianBlur(view, (0, 0), blur_sigma)
    if noise > 0:
        view = view + rng.standard_normal(view.shape) * noise
    view = np.clip(view, 0, 255)
    return view, gt
