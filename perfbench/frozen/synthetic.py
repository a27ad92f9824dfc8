"""Frozen copy of the synthetic rig generator: the traffic of the calibration
and bundle-adjustment cells.

Copied verbatim from ``multicam_calibration_tpu_torch/synthetic.py`` and
``multicam_calibration_tpu_torch/detection/board.py`` at commit ab4aaad3d64c
(numpy only), so the benchmark's inputs stay fixed when the program changes.
``perfbench/tests/test_perfbench_frozen.py`` holds the copy to the program's
generator while the two agree.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def generate_chessboard_objpoints(chess_board_shape, chess_board_square_size):
    """Canonical 3D chessboard corner coordinates (z=0 plane, row-major).

    Parity with the reference package's ``generate_chessboard_objpoints``
    (multicam_calibration/detection.py:492-518): the first point is at the
    origin and points advance ``square_size`` apart along the grid in the
    same ordering.
    """
    rows, cols = chess_board_shape
    grid = np.mgrid[0:rows, 0:cols].T.reshape(-1, 2).astype(np.float64)
    objpoints = np.zeros((rows * cols, 3))
    objpoints[:, :2] = grid * chess_board_square_size
    return objpoints


@dataclasses.dataclass
class SyntheticRig:
    """Ground truth plus observations for a synthetic calibration session."""

    # Ground truth
    all_extrinsics: np.ndarray  # (n_cameras, 6) world->camera
    all_intrinsics: list  # list of (camera_matrix (3,3), dist_coefs (5,))
    calib_poses: np.ndarray  # (n_frames, 6) board->world
    calib_objpoints: np.ndarray  # (N, 3)
    # Observations
    all_calib_uvs: np.ndarray  # (n_cameras, n_frames, N, 2) with NaN dropouts
    img_sizes: list  # list of (width, height)

    @property
    def n_cameras(self):
        return self.all_calib_uvs.shape[0]

    @property
    def n_frames(self):
        return self.all_calib_uvs.shape[1]


def _project_np(points, extrinsics, camera_matrix, dist_coefs):
    """Numpy forward model identical to ops.projection.project_points.

    Kept in numpy (not JAX) so the generator is an *independent* oracle of the
    device code paths it is used to test.
    """
    rvec, tvec = extrinsics[:3], extrinsics[3:]
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = rvec / theta
        K_ = np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
        )
        R = np.eye(3) + np.sin(theta) * K_ + (1 - np.cos(theta)) * K_ @ K_
    pc = points @ R.T + tvec
    x, y = pc[..., 0] / pc[..., 2], pc[..., 1] / pc[..., 2]
    k1, k2, p1, p2, k3 = np.pad(np.asarray(dist_coefs), (0, max(0, 5 - len(dist_coefs))))[:5]
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    K = camera_matrix
    u = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], axis=-1)


def make_camera_ring(
    n_cameras,
    radius=1.0,
    height=0.4,
    img_size=(1280, 1024),
    focal=900.0,
    rng=None,
):
    """Cameras on a ring looking at the origin (the 6/12/64-camera rigs).

    Returns (all_extrinsics (n,6) world->cam, all_intrinsics, img_sizes).
    Camera 0 sits at angle 0; consecutive cameras are neighbors so spanning
    trees over shared detections are nontrivial.
    """
    rng = rng or np.random.default_rng(0)
    extrinsics, intrinsics, img_sizes = [], [], []
    for i in range(n_cameras):
        angle = 2 * np.pi * i / n_cameras
        cam_pos = np.array(
            [radius * np.cos(angle), radius * np.sin(angle), height]
        )
        # Build world->camera: camera looks at origin, z forward.
        z_axis = -cam_pos / np.linalg.norm(cam_pos)
        up = np.array([0.0, 0.0, 1.0])
        x_axis = np.cross(z_axis, up)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R_wc = np.stack([x_axis, y_axis, z_axis])  # world->camera rotation
        t_wc = -R_wc @ cam_pos
        rvec = _rotmat_to_rotvec(R_wc)
        extrinsics.append(np.concatenate([rvec, t_wc]))
        fx = focal * (1 + rng.uniform(-0.03, 0.03))
        fy = focal * (1 + rng.uniform(-0.03, 0.03))
        cx = img_size[0] / 2 + rng.uniform(-8, 8)
        cy = img_size[1] / 2 + rng.uniform(-8, 8)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        dist = np.array(
            [rng.uniform(-0.25, 0.1), rng.uniform(-0.03, 0.03), 0, 0, 0]
        )
        intrinsics.append((K, dist))
        img_sizes.append(img_size)
    return np.array(extrinsics), intrinsics, img_sizes


def make_board_trajectory(n_frames, n_cameras_hint=6, rng=None, scale=0.35):
    """Smooth random SE(3) trajectory of the board through the ring's center.

    Poses are board->world 6-vectors; the board tumbles (full SO(3) coverage
    over time) while translating inside the rig volume, mimicking a person
    waving a checkerboard (docs/source/setup.rst capture protocol).
    """
    rng = rng or np.random.default_rng(1)
    t = np.linspace(0, 1, n_frames)
    n_waves = max(3, n_frames // 50)
    trans = np.zeros((n_frames, 3))
    rotv = np.zeros((n_frames, 3))
    for k in range(1, n_waves + 1):
        phase = rng.uniform(0, 2 * np.pi, size=(2, 3))
        amp_t = rng.uniform(0.2, 1.0, size=3) * scale / k
        amp_r = rng.uniform(0.2, 1.0, size=3) * 1.8 / k
        trans += amp_t * np.sin(2 * np.pi * k * t[:, None] + phase[0])
        rotv += amp_r * np.sin(2 * np.pi * k * t[:, None] + phase[1])
    trans[:, 2] += 0.4  # hover at ring height
    return np.concatenate([rotv, trans], axis=-1)


def render_observations(
    all_extrinsics,
    all_intrinsics,
    img_sizes,
    calib_poses,
    calib_objpoints,
    noise_px=0.3,
    dropout=0.3,
    outlier_frac=0.0,
    outlier_px=30.0,
    rng=None,
):
    """Project board points into every camera; apply visibility + noise.

    A frame is visible to a camera when all corners land inside the image and
    in front of the camera (plus a random per-(cam, frame) dropout to mimic
    detection failures). Invisible (camera, frame) pairs are NaN, matching
    the reference's detection output format (detection.py:228-233).
    """
    rng = rng or np.random.default_rng(2)
    n_cameras = len(all_extrinsics)
    n_frames = len(calib_poses)
    N = len(calib_objpoints)
    uvs = np.full((n_cameras, n_frames, N, 2), np.nan)
    board_world = np.zeros((n_frames, N, 3))
    for f in range(n_frames):
        T = _t6_to_T(calib_poses[f])
        board_world[f] = calib_objpoints @ T[:3, :3].T + T[:3, 3]
    for c in range(n_cameras):
        K, dist = all_intrinsics[c]
        w, h = img_sizes[c]
        T = _t6_to_T(all_extrinsics[c])
        pts_cam = board_world @ T[:3, :3].T + T[:3, 3]
        proj = _project_np(
            board_world.reshape(-1, 3), all_extrinsics[c], K, dist
        ).reshape(n_frames, N, 2)
        in_front = pts_cam[..., 2] > 0.05
        in_img = (
            (proj[..., 0] >= 0)
            & (proj[..., 0] < w)
            & (proj[..., 1] >= 0)
            & (proj[..., 1] < h)
        )
        visible = np.all(in_front & in_img, axis=-1)
        visible &= rng.uniform(size=n_frames) > dropout
        proj += rng.standard_normal(proj.shape) * noise_px
        if outlier_frac > 0:
            bad = rng.uniform(size=n_frames) < outlier_frac
            proj[bad] += rng.standard_normal(proj[bad].shape) * outlier_px
        uvs[c, visible] = proj[visible]
    return uvs


def make_synthetic_rig(
    n_cameras=6,
    n_frames=200,
    board_shape=(5, 7),
    square_size=12.5,
    noise_px=0.3,
    dropout=0.3,
    outlier_frac=0.0,
    seed=0,
    img_size=(1280, 1024),
):
    """End-to-end synthetic session at reference workload shapes.

    Defaults mirror the tutorial rig: board_shape=(5,7), square_size=12.5 mm
    (calibration_tutorial.ipynb cell 2). Board units are mm, so the rig
    geometry is scaled to mm as well.
    """
    rng = np.random.default_rng(seed)
    objpoints = generate_chessboard_objpoints(board_shape, square_size)
    extent = float(np.abs(objpoints).max())
    radius = extent * 10  # rig diameter ~20 board widths
    all_extrinsics, all_intrinsics, img_sizes = make_camera_ring(
        n_cameras, radius=radius, height=radius * 0.35, img_size=img_size, rng=rng
    )
    calib_poses = make_board_trajectory(n_frames, rng=rng, scale=radius * 0.3)
    # Recenter board points around the board centroid so it tumbles in place.
    calib_poses[:, 3:] -= objpoints.mean(0)
    # Re-express everything with camera 0 as the world frame (reference
    # convention: root camera extrinsics are the identity,
    # calibration.py:200-236). Both camera extrinsics AND board poses must be
    # rebased so projections are unchanged.
    T0 = _t6_to_T(all_extrinsics[0])
    T0_inv = np.linalg.inv(T0)
    all_extrinsics = np.stack(
        [_T_to_t6(_t6_to_T(e) @ T0_inv) for e in all_extrinsics]
    )
    calib_poses = np.stack([_T_to_t6(T0 @ _t6_to_T(p)) for p in calib_poses])
    all_calib_uvs = render_observations(
        all_extrinsics,
        all_intrinsics,
        img_sizes,
        calib_poses,
        objpoints,
        noise_px=noise_px,
        dropout=dropout,
        outlier_frac=outlier_frac,
        rng=rng,
    )
    return SyntheticRig(
        all_extrinsics=all_extrinsics,
        all_intrinsics=all_intrinsics,
        calib_poses=calib_poses,
        calib_objpoints=objpoints,
        all_calib_uvs=all_calib_uvs,
        img_sizes=img_sizes,
    )


def _t6_to_T(t6):
    T = np.eye(4)
    rvec = np.asarray(t6[:3], dtype=float)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = rvec / theta
        K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K_ + (1 - np.cos(theta)) * K_ @ K_
    T[:3, :3] = R
    T[:3, 3] = t6[3:]
    return T


def _rotmat_to_rotvec(R):
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    cos_theta = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_theta)
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.zeros(3)
    return v * theta / s


def _T_to_t6(T):
    return np.concatenate([_rotmat_to_rotvec(T[:3, :3]), T[:3, 3]])
