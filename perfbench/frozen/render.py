"""Frozen copy of the session-like frame generator: the traffic of the
detection cells.

Copied at commit ab4aaad3d64c from ``chip_smoke.py`` (``VIDEO``,
``video_rig``, ``render_camera``'s view classification and rendering) and
``multicam_calibration_tpu_torch/detection/synthetic_images.py``
(``render_board_image``, ``distort_pixels``, ``undistort_pixel_map``,
``render_board_view`` without its nuisance factors), and
``multicam_calibration_tpu_torch/ops/rotation.py:so3_log`` in numpy (the rig's
rebase onto camera 0 needs a log that holds at a half turn). The copies
import nothing of the program. ``cv2`` is imported inside the functions that
render, which run in worker processes.
"""
from __future__ import annotations

import numpy as np

from . import synthetic as syn

OFF_IMAGE = np.array([[1.0, 0, 1e5], [0, 1.0, 1e5], [0, 0, 1.0]])  # board far off-image


def so3_log(R):
    """Rotation matrix (3, 3) -> axis-angle 3-vector (Shepperd's
    quaternion extraction, accurate at 0 and at a half turn)."""
    m = np.asarray(R, float)
    t = np.array([1.0 + m[0, 0] + m[1, 1] + m[2, 2], 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                  1.0 - m[0, 0] + m[1, 1] - m[2, 2], 1.0 - m[0, 0] - m[1, 1] + m[2, 2]])
    cand = np.array([
        [t[0], m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], t[1], m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], t[2], m[1, 2] + m[2, 1]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], t[3]],
    ])
    q = cand[int(np.argmax(t))]
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    n = np.linalg.norm(q[1:])
    scale = 2.0 / max(q[0], 1e-30) if n < 1e-8 else 2.0 * np.arctan2(n, q[0]) / n
    return q[1:] * scale


def t6(T):
    return np.concatenate([so3_log(T[:3, :3]), T[:3, 3]])


def video_rig(n_cameras, n_frames, radius_mm, excursion_mm, img_size, noise_px, dropout,
              board_shape, square_mm, seed):
    """``make_synthetic_rig``'s construction, step for step, with the ring
    radius and the board trajectory's scale given, and the rebase onto
    camera 0 through ``so3_log``. Returns the rig and the rebase (camera 0's
    world -> camera transform before it)."""
    rng = np.random.default_rng(seed)
    objp = syn.generate_chessboard_objpoints(board_shape, square_mm)
    ext, intr, sizes = syn.make_camera_ring(n_cameras, radius=radius_mm,
                                            height=radius_mm * 0.35, img_size=img_size, rng=rng)
    poses = syn.make_board_trajectory(n_frames, rng=rng, scale=excursion_mm)
    poses[:, 3:] -= objp.mean(0)
    T0 = syn._t6_to_T(ext[0])  # camera 0's frame is the world frame
    ext = np.stack([t6(syn._t6_to_T(e) @ np.linalg.inv(T0)) for e in ext])
    poses = np.stack([t6(T0 @ syn._t6_to_T(p)) for p in poses])
    uvs = syn.render_observations(ext, intr, sizes, poses, objp, noise_px=noise_px,
                                  dropout=dropout, rng=rng)
    return syn.SyntheticRig(ext, intr, poses, objp, uvs, sizes), T0


def render_board_image(board_shape=(5, 7), square_px=40, margin_squares=2, anchor=True):
    """Canonical fronto-parallel board image + ground-truth corner coords."""
    rows, cols = board_shape
    m = margin_squares
    H = (rows + 1 + 2 * m) * square_px
    W = (cols + 1 + 2 * m) * square_px
    img = np.full((H, W), 255.0)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                y0, x0 = (m + i) * square_px, (m + j) * square_px
                img[y0: y0 + square_px, x0: x0 + square_px] = 0.0
    ys = (m + 1 + np.arange(rows)) * square_px
    xs = (m + 1 + np.arange(cols)) * square_px
    corners = np.stack([np.repeat(xs, rows), np.tile(ys, cols)], axis=-1).astype(float)
    if anchor:
        cy = ys[0] - 0.5 * square_px
        cx = xs[0] - 2.5 * square_px
        yy, xx = np.mgrid[0:H, 0:W]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= (0.5 * square_px) ** 2] = 0.0
    return img, corners


def distort_pixels(uv, camera_matrix, dist_coefs):
    """Ideal (pinhole) pixel coords -> distorted pixel coords (radial k1, k2)."""
    K = np.asarray(camera_matrix, float)
    d = np.asarray(dist_coefs, float).ravel()
    k1 = d[0] if d.size > 0 else 0.0
    k2 = d[1] if d.size > 1 else 0.0
    xy = (np.asarray(uv, float) - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    r2 = np.sum(xy**2, axis=-1, keepdims=True)
    xy_d = xy * (1.0 + k1 * r2 + k2 * r2**2)
    return xy_d * np.array([K[0, 0], K[1, 1]]) + K[:2, 2]


def undistort_pixel_map(out_size, camera_matrix, dist_coefs, n_iters=10):
    """Per-output-pixel map: distorted pixel -> ideal (pinhole) pixel, (h, w, 2) f32."""
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
    return np.stack([xu * K[0, 0] + K[0, 2], yu * K[1, 1] + K[1, 2]], axis=-1).astype(np.float32)


def render_board_view(H_board_to_view, out_size, board_shape, camera_matrix, dist_coefs,
                      ideal_map, noise, blur_sigma, seed, square_px=40):
    """Warp the canonical board through a homography (canonical pixels ->
    ideal view pixels) and the camera's lens into a view; returns (view (h,
    w) float in [0, 255], ground-truth corners (N, 2) in distorted pixels).
    ``ideal_map`` is ``undistort_pixel_map`` of this camera, computed once."""
    import cv2

    canonical, corners = render_board_image(board_shape, square_px)
    h, w = out_size
    H = np.asarray(H_board_to_view, float)
    Hinv = np.linalg.inv(H)
    pts = np.concatenate([ideal_map.reshape(-1, 2), np.ones((h * w, 1), np.float32)], 1)
    src = pts @ Hinv.T
    src = (src[:, :2] / src[:, 2:]).reshape(h, w, 2).astype(np.float32)
    view = cv2.remap(canonical, src[..., 0], src[..., 1], cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=180.0)
    proj = np.concatenate([corners, np.ones((len(corners), 1))], axis=1) @ H.T
    gt = distort_pixels(proj[:, :2] / proj[:, 2:], camera_matrix, dist_coefs)
    rng = np.random.default_rng(seed)
    if blur_sigma > 0:
        view = cv2.GaussianBlur(view, (0, 0), blur_sigma)
    if noise > 0:
        view = view + rng.standard_normal(view.shape) * noise
    return np.clip(view, 0, 255), gt


def _lattice(uv, rows):
    """(cols, rows, 2) grid of a board's corners (corner k = c * rows + r)."""
    return np.asarray(uv).reshape(-1, rows, 2)


def board_homography(can, ideal):
    """The homography taking the canonical corners onto their ideal pixels (DLT)."""
    A = []
    for (x, y), (u, v) in zip(can, ideal):
        A += [[x, y, 1, 0, 0, 0, -u * x, -u * y, -u], [0, 0, 0, x, y, 1, -v * x, -v * y, -v]]
    return np.linalg.svd(np.asarray(A))[2][-1].reshape(3, 3)


def classify_views(rig, cam, board_shape, margin_px, pitch_px, tilt_deg, need=None):
    """Per frame of one camera: (shown (F,), detectable (F,), H (F, 3, 3)).
    With ``need`` = (detectable, board-less), the arrays end at the frame
    that completes both counts.
    A view shows the board where the board is in front of the camera, faces
    it and the rig did not drop it. It is detectable where the board faces
    the camera at most ``tilt_deg`` off the line of sight, the whole sheet
    lies ``margin_px`` inside the image and no two neighbouring corners are
    closer than ``pitch_px`` (chip_smoke's phase 20 definition)."""
    ext, (K, dist) = rig.all_extrinsics[cam], rig.all_intrinsics[cam]
    w, h = rig.img_sizes[cam]
    rows = board_shape[0]
    sheet_img, can = render_board_image(board_shape, 40)
    sheet = np.array([[0.0, 0.0, 1.0], [sheet_img.shape[1], 0, 1],
                      [sheet_img.shape[1], sheet_img.shape[0], 1], [0, sheet_img.shape[0], 1]])
    Tc = syn._t6_to_T(ext)
    F = len(rig.calib_poses)
    shown, detectable = np.zeros(F, bool), np.zeros(F, bool)
    Hs = np.tile(OFF_IMAGE, (F, 1, 1))

    def inside(p, m):
        return bool((p >= m).all() and (p[:, 0] < w - m).all() and (p[:, 1] < h - m).all())

    n_without, stop = 0, F
    for f in range(F):
        if need is not None and detectable.sum() >= need[0] and n_without >= need[1]:
            stop = f
            break
        Tb = syn._t6_to_T(rig.calib_poses[f])
        world = rig.calib_objpoints @ Tb[:3, :3].T + Tb[:3, 3]
        in_cam = world @ Tc[:3, :3].T + Tc[:3, 3]
        if not (in_cam[:, 2] > 0.05).all():
            n_without += 1
            continue
        real = syn._project_np(world, ext, K, dist)
        if inside(real, 0) and np.isnan(rig.all_calib_uvs[cam, f]).any():
            n_without += 1
            continue  # dropped by the rig: rendered board-less
        ideal = syn._project_np(world, ext, K, np.zeros(5))
        g = _lattice(ideal, rows)
        e_c, e_r = np.diff(g, axis=0).mean((0, 1)), np.diff(g, axis=1).mean((0, 1))
        if e_c[0] * e_r[1] - e_c[1] * e_r[0] <= 0:
            n_without += 1
            continue  # the board's back faces the camera
        shown[f] = True
        Hs[f] = board_homography(can, ideal)
        normal = Tc[:3, :3] @ Tb[:3, :3][:, 2]
        ray = in_cam.mean(0)
        tilt = np.degrees(np.arccos(min(1.0, abs(normal @ ray) / np.linalg.norm(ray))))
        gl = _lattice(real, rows)
        pitch = min(np.linalg.norm(np.diff(gl, axis=a), axis=-1).min() for a in (0, 1))
        corners = sheet @ Hs[f].T
        corners = distort_pixels(corners[:, :2] / corners[:, 2:], K, dist)
        detectable[f] = inside(corners, margin_px) and pitch >= pitch_px and tilt <= tilt_deg
    return shown[:stop], detectable[:stop], Hs[:stop]


def render_views(K, dist, img_size, Hs, board_shape, noise, blur_sigma, seeds):
    """Render one camera's views (a worker process's job): uint8 frames
    (n, h, w) and the ground-truth corners (n, N, 2) of each homography;
    a view with ``OFF_IMAGE`` shows no board. One BLAS / OpenCV thread."""
    import cv2

    cv2.setNumThreads(1)
    w, h = img_size
    ideal_map = undistort_pixel_map((h, w), K, dist)
    frames = np.empty((len(Hs), h, w), np.uint8)
    truth = np.empty((len(Hs), board_shape[0] * board_shape[1], 2))
    for i, (H, s) in enumerate(zip(Hs, seeds)):
        view, truth[i] = render_board_view(H, (h, w), board_shape, K, dist, ideal_map,
                                           noise, blur_sigma, int(s))
        frames[i] = view.astype(np.uint8)
    return frames, truth
