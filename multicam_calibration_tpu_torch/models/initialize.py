"""Calibration initialization: intrinsics, per-frame poses, extrinsics chain.

Counterpart of ``multicam_calibration_tpu/models/initialize.py`` in eager
PyTorch, with the JAX names:

- ``get_intrinsics`` — Zhang's closed-form init (homographies -> image of
  the absolute conic -> K) followed by a single-camera LM refine of
  (fx, fy, cx, cy, k1, k2) + board poses with the Schur LM engine
  (extrinsics frozen at identity), and a fixed-principal-point basin guard.
- ``get_intrinsics_batch`` — the same for every camera at once, as the JAX
  package's: one camera-vmapped Zhang init (``_batched_zhang_init``) and
  one lockstep LM over the cameras (``_batched_intrinsics_refine`` on
  ``lm_core._lm_solve_lanes``), a second one from the fixed-principal-point
  starts when the guard flags any camera.
- ``estimate_pose`` — batched planar-homography pose extraction, a
  Gauss-Newton polish of every frame at once, and the planar twin-pose
  check: on CUDA tensors the polish of a slab is one launch of
  ``pose_gn_kernel`` (``ops.pose_cuda``), on CPU tensors its plain twin
  ``pose_gn_refine_reference`` (``torch.func.jacfwd`` rows, vmapped over
  cameras).
- ``get_camera_spanning_tree`` / ``estimate_all_extrinsics`` /
  ``consensus_calib_poses`` — the maximum spanning tree over co-detections
  (host numpy), pairwise-transform medians chained along it, and the
  per-frame median world pose across cameras (masked medians).
- ``calibrate`` — the stage driver, with the JAX signature and returns.

Entry points take numpy (or tensors) and run on ``device``: None means the
CUDA device (raising without one) unless a tensor argument brings its own;
pass ``device="cpu"`` for the CPU. Everything runs in f64. The intrinsics
solves, per camera and batched, use ``LMOptions(max_iters=60, ftol=1e-6,
loss="linear")`` in f64, which is not the kernels' all-f32 recipe: they take
lm_core's plain torch route on every device, as the JAX package's routing
does (lm_core.py:390-430).

``torch.linalg.svd``/``eigh`` raise on non-finite input where JAX returns
NaN; the functions below that factor matrices from detections hand them
finite stand-ins there and put NaN back in the result, so undetected frames
come out NaN as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, with_highest_precision
from ..ops.homography import fit_homography
from ..ops.pose_cuda import pose_gn_refine
from ..ops.projection import distortion_valid_r2, undistort_points
from ..ops.reductions import masked_median
from ..ops.rotation import so3_exp, so3_log
from ..ops.transforms import (
    get_transformation_matrix,
    get_transformation_vector,
    se3_inverse,
)
from ..utils.metrics import metrics
from .lm_core import (
    LMOptions,
    _cholesky,
    _lm_solve_lanes,
    _predict,
    lm_solve,
    project_board_points,
)

__all__ = [
    "estimate_board_homographies",
    "intrinsics_from_homographies",
    "intrinsics_from_homographies_fixed_pp",
    "poses_from_homographies",
    "get_intrinsics",
    "get_intrinsics_batch",
    "estimate_pose",
    "estimate_pose_batch",
    "estimate_pairwise_camera_transform",
    "get_camera_spanning_tree",
    "estimate_all_extrinsics",
    "consensus_calib_poses",
    "calibrate",
]

_F64 = torch.float64
# Camera-frames per batched pose call: cuSOLVER's batched eigh (the
# homography fit) refuses 32,768 matrices or more on the H100 (a probe of
# 6x6 and 9x9 batches: 24,000 pass), and a 64-camera rig of 2,000 frames is
# 128,000. The largest power of two below that limit.
POSE_BATCH = 16384


def _host(x):
    """numpy of an array-like, scalar or tensor (tensors are copied to the
    host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x, device):
    """f64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _finite_frames(M):
    """(finite, M with non-finite matrices replaced by the identity) for a
    batch of square matrices M (..., n, n)."""
    ok = torch.isfinite(M).flatten(-2).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return ok, torch.where(ok[..., None, None], M, eye)


def estimate_board_homographies(calib_uvs, objpoints, mask=None):
    """Batched board-plane -> image homographies, one per frame.

    ``calib_uvs``: (F, N, 2) tensor (NaN ok); ``objpoints``: (N, 3) with
    z=0. Returns (Hs (F, 3, 3), valid (F,)).
    """
    if mask is None:
        mask = torch.isfinite(calib_uvs).flatten(-2).all(-1)
    uvs = torch.nan_to_num(calib_uvs)
    xy = objpoints[:, :2].expand(uvs.shape)
    return fit_homography(xy, uvs), mask


def intrinsics_from_homographies(Hs, valid, zero_skew=True):
    """Zhang's closed-form camera matrix from >= 3 board homographies.

    Each homography contributes two linear constraints on the image of the
    absolute conic B = K^-T K^-1; K is recovered from B in closed form.
    Invalid frames are weight-0 rows. The conic is the smallest eigenvector
    of A^T A, its sign fixed by B11 > 0.
    """

    def v_ij(i, j):
        H = Hs
        return torch.stack(
            [
                H[:, 0, i] * H[:, 0, j],
                H[:, 0, i] * H[:, 1, j] + H[:, 1, i] * H[:, 0, j],
                H[:, 1, i] * H[:, 1, j],
                H[:, 2, i] * H[:, 0, j] + H[:, 0, i] * H[:, 2, j],
                H[:, 2, i] * H[:, 1, j] + H[:, 1, i] * H[:, 2, j],
                H[:, 2, i] * H[:, 2, j],
            ],
            dim=-1,
        )

    A = torch.stack([v_ij(0, 1), v_ij(0, 0) - v_ij(1, 1)], dim=1)  # (F, 2, 6)
    w = valid.to(Hs.dtype)[:, None, None]
    A = (A * w).reshape(-1, 6)
    if zero_skew:
        # Strong prior row: B12 = 0 (zero skew), scaled to the data rows.
        scale = torch.sqrt(torch.mean(torch.sum(A**2, dim=-1)) + 1e-30)
        skew_row = torch.tensor(
            [0.0, 1.0, 0.0, 0.0, 0.0, 0.0], dtype=Hs.dtype, device=Hs.device
        ) * scale
        A = torch.cat([A, skew_row[None]], dim=0)
    ok, ATA = _finite_frames(A.T @ A)
    _, vecs = torch.linalg.eigh(ATA)
    b = torch.where(ok, vecs[:, 0], torch.nan)
    b = b * torch.sign(b[0] + 1e-30)  # B11 > 0 for a valid conic
    B11, B12, B22, B13, B23, B33 = b[0], b[1], b[2], b[3], b[4], b[5]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
    lam = B33 - (B13**2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12**2)))
    gamma = -B12 * alpha**2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha**2 / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([
        torch.stack([alpha, gamma, u0]),
        torch.stack([zero, beta, v0]),
        torch.stack([zero, zero, one]),
    ])


def intrinsics_from_homographies_fixed_pp(Hs, valid, image_size):
    """Focal-only closed-form init with the principal point pinned at the
    image center (cv2.initCameraMatrix2D's assumption).

    Zhang's 5-dof estimate degenerates under weak view diversity; pinning
    (cx, cy) and zero skew leaves X = 1/fx^2, Y = 1/fy^2, two linear
    constraints per homography of H' = T(-center) @ H, solved as a 2x2
    normal system by Cramer's rule with a 1e-12 ridge. The alternative LM
    start of :func:`get_intrinsics`. ``image_size`` (w, h) may be a tensor,
    so the function runs under ``torch.vmap`` (:func:`_batched_zhang_init`).
    """
    size = image_size if isinstance(image_size, torch.Tensor) else _t(
        np.asarray(image_size, np.float64).reshape(-1)[:2], Hs.device)
    cx, cy = size[0].to(Hs.dtype) / 2.0, size[1].to(Hs.dtype) / 2.0
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    T = torch.stack([
        torch.stack([one, zero, -cx]),
        torch.stack([zero, one, -cy]),
        torch.stack([zero, zero, one]),
    ])
    Hc = torch.einsum("ij,fjk->fik", T, Hs)
    a1, a2 = Hc[:, 0, 0], Hc[:, 0, 1]
    b1, b2 = Hc[:, 1, 0], Hc[:, 1, 1]
    c1, c2 = Hc[:, 2, 0], Hc[:, 2, 1]
    # h1^T B h2 = 0 ; h1^T B h1 - h2^T B h2 = 0, B = diag(X, Y, 1)
    A = torch.stack([
        torch.stack([a1 * a2, b1 * b2], dim=-1),
        torch.stack([a1 * a1 - a2 * a2, b1 * b1 - b2 * b2], dim=-1),
    ], dim=-2)  # (F, 2, 2)
    r = torch.stack([-c1 * c2, -(c1 * c1 - c2 * c2)], dim=-1)
    wgt = valid.to(Hs.dtype)[:, None, None]
    A = (A * wgt).reshape(-1, 2)
    r = (r * wgt[..., 0]).reshape(-1)
    ATA = A.T @ A + 1e-12 * torch.eye(2, dtype=Hs.dtype, device=Hs.device)
    Ab = A.T @ r
    det = ATA[0, 0] * ATA[1, 1] - ATA[0, 1] * ATA[1, 0]
    XY = torch.stack([
        ATA[1, 1] * Ab[0] - ATA[0, 1] * Ab[1],
        ATA[0, 0] * Ab[1] - ATA[1, 0] * Ab[0],
    ]) / det
    fx = 1.0 / torch.sqrt(torch.clamp(XY[0], min=1e-12))
    fy = 1.0 / torch.sqrt(torch.clamp(XY[1], min=1e-12))
    return torch.stack([
        torch.stack([fx, zero, cx]),
        torch.stack([zero, fy, cy]),
        torch.stack([zero, zero, one]),
    ])


def _intrinsics_field_valid(cam6, image_size):
    """True when a refined (fx,fy,cx,cy,k1,k2) solution is physically
    usable over its own image field: the radial model stays monotonic
    (invertible) out to the farthest image corner (host-side)."""
    vals = [float(v) for v in _host(cam6).reshape(-1)[:6]]
    fx, fy, cx, cy, k1, k2 = vals
    if not np.all(np.isfinite(vals)) or fx <= 0 or fy <= 0:
        return False
    w, h = float(image_size[0]), float(image_size[1])
    r2_corner = max(
        (x / fx) ** 2 for x in (cx, w - cx)
    ) + max((y / fy) ** 2 for y in (cy, h - cy))
    return distortion_valid_r2([k1, k2]) > r2_corner


def poses_from_homographies(Hs, K):
    """Planar pose extraction: H = K [r1 r2 t] (up to scale) -> (F, 6).

    Orthonormalizes [r1 r2 r1xr2] by SVD (the det correction makes the
    result independent of the SVD's signs) and flips the scale sign so the
    board sits in front of the camera (t_z > 0). Non-finite H give NaN.
    """
    M = torch.linalg.solve_triangular(K.expand(Hs.shape), Hs, upper=True)
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(M[:, :, 0], dim=-1), min=1e-30)
    # Board must be in front of the camera: t_z > 0 fixes the sign.
    lam = (lam * torch.sign(M[:, 2, 2] + 1e-30))[:, None]
    r1 = M[:, :, 0] * lam
    r2 = M[:, :, 1] * lam
    t = M[:, :, 2] * lam
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    ok, R_approx = _finite_frames(torch.stack([r1, r2, r3], dim=-1))
    U, _, Vt = torch.linalg.svd(R_approx)
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    out = torch.cat([so3_log(R), t], dim=-1)
    return torch.where(ok[:, None], out, torch.nan)


def _refine_poses_gn(poses, cam12, calib_uvs, mask, objpoints, n_iters=10):
    """Batched per-frame 6-dof Gauss-Newton polish (replaces solvePnP's LM).

    All frames refine at once: rows from ``torch.func.jacfwd`` of the
    masked residual (vmapped over frames), a 1e-8 ridge and a Cholesky
    solve per frame, ``n_iters`` fixed steps. This is the plain route, run
    for CPU tensors (through :func:`_polish_poses`); on CUDA tensors
    ``ops.pose_cuda.pose_gn_refine`` runs the same steps in one kernel.
    """
    from torch.func import jacfwd, vmap

    uvs = torch.nan_to_num(calib_uvs)
    m = mask.to(poses.dtype)[..., None]

    def residual(pose6, uvs_f, m_f):
        pred = project_board_points(cam12, pose6, objpoints)
        return ((uvs_f - pred) * m_f).reshape(-1)

    res_fn = vmap(residual)
    jac_fn = vmap(jacfwd(residual))
    ridge = 1e-8 * torch.eye(6, dtype=poses.dtype, device=poses.device)
    for _ in range(n_iters):
        # J is d(residual)/d(pose) = -d(pred)/d(pose); the GN increment is
        # -(J^T J)^{-1} J^T r.
        r = res_fn(poses, uvs, m)
        J = jac_fn(poses, uvs, m)
        H = J.mT @ J + ridge
        g = J.mT @ r[..., None]
        L = _cholesky(H)
        y = torch.linalg.solve_triangular(L, g, upper=False)
        poses = poses - torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return poses


def _twin_planar_pose(pose6):
    """The second solution of the planar-pose ambiguity (batched, (F, 6)).

    Planar PnP has two local minima at shallow viewing angles: the board
    normal n reflects across the line of sight v. The twin rotates the pose
    so n -> 2(v.n)v - n.
    """
    R = so3_exp(pose6[..., :3])
    t = pose6[..., 3:]
    n = R[..., :, 2]  # board normal in camera frame
    v = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    dot = torch.sum(v * n, dim=-1, keepdim=True)
    n2 = 2.0 * dot * v - n
    # Rotation taking n -> n2 (about axis n x n2).
    axis = torch.linalg.cross(n, n2, dim=-1)
    sin = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cos = torch.clamp(torch.sum(n * n2, dim=-1, keepdim=True), -1.0, 1.0)
    angle = torch.atan2(sin, cos)
    axis_unit = axis / torch.clamp(sin, min=1e-12)
    r_align = torch.where(sin > 1e-8, axis_unit * angle, torch.zeros_like(axis))
    R_twin = so3_exp(r_align) @ R
    return torch.cat([so3_log(R_twin), t], dim=-1)


def _cam12(K, dist):
    """(12,) camera vector of intrinsics K, dist with identity extrinsics."""
    return torch.cat([
        torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        dist[:2],
        torch.zeros(6, dtype=K.dtype, device=K.device),
    ])


def _polish_poses(poses0, cam12, calib_uvs, mask, objpoints):
    """One camera's polish of both branches of the planar-pose ambiguity:
    (F, 6) homography poses, (12,) camera, (F, N, 2) detections, (F,) mask
    -> (F, 6), the better branch of each frame, NaN rows where ``mask`` is
    false. The plain twin of ``pose_gn_kernel``
    (:func:`pose_gn_refine_reference` vmaps it over cameras)."""
    point_mask = mask[:, None].expand(calib_uvs.shape[:2])
    poses_a = _refine_poses_gn(poses0, cam12, calib_uvs, point_mask, objpoints)
    poses_b = _refine_poses_gn(
        _twin_planar_pose(poses_a), cam12, calib_uvs, point_mask, objpoints
    )

    def sq_err(poses):
        pred = _predict(cam12[None], poses, objpoints)[0]
        r = torch.where(
            point_mask[..., None], torch.nan_to_num(calib_uvs) - pred, 0.0
        )
        return torch.sum(r**2, dim=(-1, -2))

    better_b = sq_err(poses_b) < sq_err(poses_a)
    poses = torch.where(better_b[:, None], poses_b, poses_a)
    return torch.where(mask[:, None], poses, torch.nan)


def pose_gn_refine_reference(poses0, cam12, uvs, mask, objpoints):
    """Plain PyTorch version of ``ops.pose_cuda.pose_gn_refine``, same
    arguments and result: :func:`_polish_poses` vmapped over cameras."""
    return torch.vmap(_polish_poses, in_dims=(0, 0, 0, 0, None))(
        poses0, cam12, uvs, mask, objpoints)


def _planar_start(calib_uvs, K, dist, objpoints):
    """One camera's (mask (F,), homography poses (F, 6), 0 where the board
    is not fully detected)."""
    mask = torch.isfinite(calib_uvs).flatten(-2).all(-1)  # (F,)
    und = undistort_points(calib_uvs, K, dist)
    Hs, _ = estimate_board_homographies(und, objpoints, mask)
    poses0 = poses_from_homographies(Hs, K)
    return mask, torch.where(mask[:, None], poses0, 0.0)


@with_highest_precision
def _estimate_poses(calib_uvs, K, dist, objpoints):
    """Board poses of a slab of cameras: (C, F, N, 2) detections, (C, 3, 3)
    K, (C, D) distortion -> (C, F, 6). The homography stage is a
    ``torch.vmap`` over cameras; the Gauss-Newton stage is one call on the
    whole (C, F) batch: one ``pose_gn_refine`` kernel launch on CUDA
    tensors, :func:`pose_gn_refine_reference` on CPU tensors. Each span is
    one entry per slab; ``estimate_pose.gn_kernel.frames`` counts the
    camera-frames the kernel polished (0 on the CPU)."""
    calib_uvs = calib_uvs.contiguous()
    with metrics.span("estimate_pose.homography"):
        mask, poses0 = torch.vmap(_planar_start, in_dims=(0, 0, 0, None))(
            calib_uvs, K, dist, objpoints)
    with metrics.span("estimate_pose.gauss_newton"):
        cam12 = torch.vmap(_cam12)(K, dist)
        on_card = calib_uvs.is_cuda
        refine = pose_gn_refine if on_card else pose_gn_refine_reference
        poses = refine(poses0.contiguous(), cam12.contiguous(), calib_uvs,
                       mask.contiguous(), objpoints.contiguous())
        metrics.count("estimate_pose.gn_kernel.frames", mask.numel() if on_card else 0)
        return poses


def _estimate_pose_impl(calib_uvs, K, dist, objpoints):
    """One camera's board poses: (F, N, 2), (3, 3), (D,) -> (F, 6), NaN rows
    where the board is not fully detected; :func:`_estimate_poses` with C =
    1."""
    return _estimate_poses(calib_uvs[None], K[None], dist[None], objpoints)[0]


def _batched_estimate_pose(calib_uvs, K, dist, objpoints):
    """Board poses of every camera at once: (C, B, N, 2) detections, (C, 3, 3)
    K and (C, 5) distortion -> (C, B, 6), NaN rows where the board is not
    fully detected. The JAX package's ``jit(vmap(_estimate_pose_impl))``:
    the homography stage is vmapped over cameras, and the Gauss-Newton
    polish of every camera-frame is one ``ops.pose_cuda.pose_gn_refine``
    call (one ``pose_gn_kernel`` launch on CUDA tensors; on CPU tensors the
    plain polish, vmapped over cameras); it equals the per-camera loop.
    Frames go in slabs of at most ``POSE_BATCH`` camera-frames (each
    frame's pose is its own), one launch a slab."""
    step = max(1, POSE_BATCH // calib_uvs.shape[0])
    if calib_uvs.shape[1] <= step:
        return _estimate_poses(calib_uvs, K, dist, objpoints)
    return torch.cat([_estimate_poses(slab, K, dist, objpoints)
                      for slab in calib_uvs.split(step, dim=1)], dim=1)


def _pick(device, *xs):
    """The device to run on: ``device`` if given, else that of the first
    tensor argument, else the CUDA device (raises without one)."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor):
                return x.device
    return resolve_device(device)


def estimate_pose(calib_uvs, calib_objpoints, camera_matrix, dist_coeffs,
                  device=None):
    """Board pose per frame for one camera: (F, 6) f64 tensor on the device,
    NaN rows where the board is not fully detected.

    Undistort -> planar homography pose -> GN polish against the full
    distorted model (both planar twins), all frames at once. A frame
    participates only if all N corners are detected.
    """
    dev = _pick(device, calib_uvs)
    uvs = _t(calib_uvs, dev)
    return _estimate_pose_impl(
        uvs, _t(camera_matrix, dev), _t(dist_coeffs, dev).reshape(-1),
        _t(calib_objpoints, dev),
    )


def estimate_pose_batch(all_calib_uvs, calib_objpoints, all_camera_matrices,
                        all_dist_coeffs, device=None):
    """Board poses for all cameras: (C, F, 6), all cameras at once through
    :func:`_batched_estimate_pose` (the per-camera results of
    :func:`estimate_pose`)."""
    dev = _pick(device, all_calib_uvs)
    return _batched_estimate_pose(
        _t(all_calib_uvs, dev),
        torch.stack([_t(K, dev) for K in all_camera_matrices]),
        torch.stack([_t(d, dev).reshape(-1) for d in all_dist_coeffs]),
        _t(calib_objpoints, dev),
    )


def _sample_frames(calib_uvs, n_samples, seed, camera=None):
    """(sample of fully-detected frame indices padded to n_samples, take)."""
    valid_ixs = np.nonzero(~np.isnan(calib_uvs).any((1, 2)))[0]
    if len(valid_ixs) < 3:
        which = "" if camera is None else f" for camera {camera}"
        raise ValueError(
            f"get_intrinsics needs >= 3 fully-detected frames, got "
            f"{len(valid_ixs)}{which} (Zhang's method requires 3+ board views)"
        )
    take = min(n_samples, len(valid_ixs))
    rng = np.random.default_rng(seed)
    sample = rng.choice(valid_ixs, take, replace=False)
    # Pad the sample to a fixed size (padded frames are all-masked).
    if take < n_samples:
        sample = np.concatenate([sample, np.full(n_samples - take, sample[0])])
    return sample, take


@with_highest_precision
def _intrinsics_from_sample(uvs, take, objpoints, image_size, opts):
    """Zhang init + LM refine + basin guard on one camera's frame sample;
    returns (camera_matrix, dist_coefs) as numpy."""
    n_samples = uvs.shape[0]
    dev = uvs.device
    mask_f = torch.arange(n_samples, device=dev) < take
    with metrics.span("calibrate.intrinsics.zhang"):
        Hs, _ = estimate_board_homographies(uvs, objpoints, mask_f)
        K0 = intrinsics_from_homographies(Hs, mask_f)
        K0_pp = intrinsics_from_homographies_fixed_pp(Hs, mask_f, image_size)

    # Refine (fx, fy, cx, cy, k1, k2) + poses jointly with the BA engine:
    # a single-camera bundle adjustment with the extrinsics frozen at
    # identity (gauge: board poses absorb all motion).
    cam_free = torch.cat([torch.ones(6, dtype=_F64, device=dev),
                          torch.zeros(6, dtype=_F64, device=dev)])[None]
    obs = uvs[None]
    point_mask = mask_f[None, :, None].expand(obs.shape[:3])

    def refine(K_init):
        cam0 = torch.cat([
            torch.stack([K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]]),
            torch.zeros(8, dtype=_F64, device=dev),
        ])[None]
        poses0 = poses_from_homographies(Hs, K_init)
        with metrics.span("calibrate.intrinsics.refine"):
            cam_ref, _, info = lm_solve(
                cam0, poses0, obs, point_mask, objpoints, opts, cam_free=cam_free
            )
            metrics.count("calibrate.intrinsics.lm_iters", int(info["n_iters"]))
            return _host(cam_ref), np.array([float(info["final_cost"])])

    cam_ref, cost = refine(K0)

    # Basin guard: when the fixed-principal-point focal estimate materially
    # disagrees with the IAC one, refine from it too and keep the better
    # field-valid solution.
    size = np.asarray(image_size, float)[None]
    flagged = _basin_guard(_host(K0)[None], _host(K0_pp)[None], size)
    if flagged[0]:
        cam_ref = _keep_alt(cam_ref, cost, *refine(K0_pp), flagged, size)
    return _intrinsics_out(cam_ref)[0]


def _basin_guard(K0, K0_pp, image_sizes):
    """Which cameras the basin guard refines from the fixed-principal-point
    start too: numpy Zhang K0 (C, 3, 3), fixed-pp K0_pp (C, 3, 3) and image
    sizes (C, 2) -> (C,) bool. Flagged where K0_pp's focal is finite and
    K0's is not, or where the two disagree by more than 15% in focal or 8%
    of the image diagonal in principal point."""
    f0, fp = K0[:, 0, 0], K0_pp[:, 0, 0]
    with np.errstate(all="ignore"):
        f_ratio = np.maximum(f0 / fp, fp / f0)
        pp_off = np.hypot(K0[:, 0, 2] - K0_pp[:, 0, 2], K0[:, 1, 2] - K0_pp[:, 1, 2]) / np.hypot(
            image_sizes[:, 0], image_sizes[:, 1])
    return np.isfinite(fp) & (~np.isfinite(f0) | (f_ratio > 1.15) | (pp_off > 0.08))


def _keep_alt(cam, cost, cam_alt, cost_alt, flagged, image_sizes):
    """The basin guard's choice between the refine from Zhang's K and the one
    from the fixed-principal-point K, per camera: numpy (C, 12) cameras and
    (C,) final costs of each, the (C,) guard flags and (C, 2) image sizes ->
    (C, 12). A flagged camera keeps the alternative by (field-valid, cost):
    when it is field-valid and the primary is not or costs more. A
    lower-cost solution whose radial model is not invertible over its own
    image field is a degenerate compensating-distortion fit, not a better
    basin."""
    def valid(cams, costs):
        return np.array([bool(np.isfinite(costs[c]))
                         and _intrinsics_field_valid(cams[c], image_sizes[c])
                         for c in range(len(cams))], dtype=bool)

    with np.errstate(invalid="ignore"):
        keep = flagged & valid(cam_alt, cost_alt) & (~valid(cam, cost) | (cost_alt < cost))
    return np.where(keep[:, None], cam_alt, cam)


def _intrinsics_out(cam):
    """Refined (C, 12) cameras -> a list of (camera_matrix (3, 3),
    dist_coefs (5,)) as numpy: (fx, fy, cx, cy, k1, k2), the rest zero."""
    return [(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]), np.array([k1, k2, 0.0, 0.0, 0.0]))
            for fx, fy, cx, cy, k1, k2 in np.asarray(cam, dtype=float)[:, :6].tolist()]


def _intrinsics_opts(lm_options):
    return lm_options or LMOptions(max_iters=60, ftol=1e-6, loss="linear")


def get_intrinsics(
    calib_uvs,
    calib_objpoints,
    image_size,
    n_samples=100,
    fix_k3=True,
    zero_tangent_dist=True,
    seed=0,
    lm_options=None,
    device=None,
):
    """Per-camera intrinsics: Zhang init + Schur-LM refine.

    A random sample of ``n_samples`` fully-detected frames; returns
    (camera_matrix (3,3), dist_coefs (5,)) as numpy. The k3/tangential
    flags are accepted for API parity and stay zero (the optimized model
    is k1,k2-radial). The refine runs lm_core's plain torch route (see the
    module docstring).
    """
    del fix_k3, zero_tangent_dist  # parity args; model is k1,k2-only
    dev = _pick(device, calib_uvs)
    calib_uvs = _host(calib_uvs)
    sample, take = _sample_frames(calib_uvs, n_samples, seed)
    uvs = _t(np.nan_to_num(calib_uvs[sample]), dev)
    return _intrinsics_from_sample(
        uvs, take, _t(calib_objpoints, dev), image_size, _intrinsics_opts(lm_options)
    )


@with_highest_precision
def _batched_zhang_init(uvs_s, mask_f, objpoints, image_sizes):
    """Homographies and both closed-form K estimates for all cameras at
    once: ``torch.vmap`` over cameras of :func:`estimate_board_homographies`,
    :func:`intrinsics_from_homographies` and
    :func:`intrinsics_from_homographies_fixed_pp`. (C, S, N, 2) samples,
    (C, S) frame mask, (C, 2) image sizes -> Hs (C, S, 3, 3), K0 (C, 3, 3),
    K0_pp (C, 3, 3). ``_finite_frames``' stand-ins keep ``eigh`` away from
    non-finite input inside the vmap."""
    Hs, _ = torch.vmap(estimate_board_homographies, in_dims=(0, None, 0))(
        uvs_s, objpoints, mask_f)
    K0 = torch.vmap(intrinsics_from_homographies)(Hs, mask_f)
    K0_pp = torch.vmap(intrinsics_from_homographies_fixed_pp)(Hs, mask_f, image_sizes)
    return Hs, K0, K0_pp


@with_highest_precision
def _batched_intrinsics_refine(K_inits, Hs, uvs_s, mask_f, objpoints, opts):
    """The single-camera intrinsics refine of every camera in one lockstep
    LM (``lm_core._lm_solve_lanes``, a lane per camera; the JAX package's
    ``vmap`` of its ``one()``): (fx, fy, cx, cy, k1, k2) and the sample's
    board poses from K_inits (C, 3, 3) and the poses of Hs, extrinsics frozen
    at identity, padded frames masked. Returns (cam (C, 12), final cost
    (C,)), each camera's result that of its own solve."""
    C = K_inits.shape[0]
    dtype, dev = uvs_s.dtype, uvs_s.device
    cam0 = torch.cat([
        torch.stack([K_inits[:, 0, 0], K_inits[:, 1, 1], K_inits[:, 0, 2], K_inits[:, 1, 2]], -1),
        torch.zeros((C, 8), dtype=dtype, device=dev),
    ], -1)[:, None]
    poses0 = torch.vmap(poses_from_homographies)(Hs, K_inits)
    obs = uvs_s[:, None]
    point_mask = mask_f[:, None, :, None].expand(obs.shape[:4])
    cam_free = torch.cat([torch.ones(6, dtype=dtype, device=dev),
                          torch.zeros(6, dtype=dtype, device=dev)])[None]
    cam_ref, _, info = _lm_solve_lanes(cam0, poses0, obs, point_mask, objpoints, opts,
                                       cam_free=cam_free)
    metrics.count("calibrate.intrinsics.lm_iters", int(info["n_iters"].max()))
    return cam_ref[:, 0], info["final_cost"]


def get_intrinsics_batch(
    all_calib_uvs,
    calib_objpoints,
    img_sizes,
    n_samples=100,
    seed=0,
    lm_options=None,
    device=None,
):
    """All cameras' intrinsics at once; a list of (camera_matrix,
    dist_coefs).

    :func:`get_intrinsics`' semantics per camera (the same sampling rng,
    Zhang init, LM refine and basin guard), batched over cameras as in the
    JAX package: one :func:`_batched_zhang_init`, one lockstep refine of
    every camera from its Zhang K (:func:`_batched_intrinsics_refine`;
    iterations = the slowest camera's, each finished camera held), and, when
    the basin guard flags any camera, a second one from the
    fixed-principal-point K, kept for a flagged camera by the
    (field-valid, cost) preference. The LM reads one pair of flags per try
    for the whole rig. Every camera's frame count is checked before any
    solve.
    """
    dev = _pick(device, all_calib_uvs)
    all_calib_uvs = _host(all_calib_uvs)
    n_cameras = all_calib_uvs.shape[0]
    samples = [
        _sample_frames(all_calib_uvs[c], n_samples, seed, camera=c)
        for c in range(n_cameras)
    ]
    uvs_s = _t(np.nan_to_num(np.stack(
        [all_calib_uvs[c, sample] for c, (sample, _) in enumerate(samples)])), dev)
    takes = torch.as_tensor([take for _, take in samples], device=dev)
    mask_f = torch.arange(n_samples, device=dev)[None, :] < takes[:, None]
    objpoints = _t(calib_objpoints, dev)
    sizes_np = np.asarray(img_sizes, dtype=float)
    opts = _intrinsics_opts(lm_options)

    with metrics.span("calibrate.intrinsics.zhang"):
        Hs, K0, K0_pp = _batched_zhang_init(uvs_s, mask_f, objpoints, _t(sizes_np, dev))
    with metrics.span("calibrate.intrinsics.refine"):
        cam_ref, cost = (_host(x) for x in _batched_intrinsics_refine(
            K0, Hs, uvs_s, mask_f, objpoints, opts))
    flagged = _basin_guard(_host(K0), _host(K0_pp), sizes_np)
    if flagged.any():
        with metrics.span("calibrate.intrinsics.refine"):
            cam_alt, cost_alt = (_host(x) for x in _batched_intrinsics_refine(
                K0_pp, Hs, uvs_s, mask_f, objpoints, opts))
        cam_ref = _keep_alt(cam_ref, cost, cam_alt, cost_alt, flagged, sizes_np)
    return _intrinsics_out(cam_ref)


def estimate_pairwise_camera_transform(camera1_poses, camera2_poses, device=None):
    """Median relative transform cam1 -> cam2 over co-observed frames:
    per-frame T2 @ T1^-1, element-wise masked median of the 6-vectors.
    Returns a (6,) tensor."""
    dev = _pick(device, camera1_poses, camera2_poses)
    p1, p2 = _t(camera1_poses, dev), _t(camera2_poses, dev)
    common = torch.isfinite(p1).all(-1) & torch.isfinite(p2).all(-1)
    T1 = get_transformation_matrix(torch.nan_to_num(p1))
    T2 = get_transformation_matrix(torch.nan_to_num(p2))
    t_rel = get_transformation_vector(T2 @ se3_inverse(T1))  # (F, 6)
    return masked_median(t_rel, common[:, None], axis=0)


def get_camera_spanning_tree(all_calib_poses, root=0):
    """Maximum spanning tree over shared-detection counts (host numpy).

    Edges are weighted by co-detection counts, the max spanning tree is
    found by Prim's algorithm, and edges are returned (parent, child) in
    BFS order from ``root``.
    """
    poses = _host(all_calib_poses)
    detected = ~np.isnan(poses).any(-1)  # (C, F)
    n = detected.shape[0]
    weights = (detected[:, None] & detected[None, :]).sum(-1)
    in_tree = {root}
    edges = []
    adj = {i: [] for i in range(n)}
    while len(in_tree) < n:
        best = None
        for i in sorted(in_tree):
            for j in range(n):
                if j in in_tree:
                    continue
                if best is None or weights[i, j] > best[2]:
                    best = (i, j, weights[i, j])
        i, j, _ = best
        in_tree.add(j)
        adj[i].append(j)
        edges.append((i, j))
    # BFS order from root, parent-first.
    order = []
    queue = [root]
    while queue:
        u = queue.pop(0)
        for v in adj[u]:
            order.append((u, v))
            queue.append(v)
    return order


def estimate_all_extrinsics(all_calib_poses, root=0, device=None):
    """Chain pairwise medians along the spanning tree; root = identity.
    Returns ((C, 6) numpy extrinsics, tree)."""
    dev = _pick(device, all_calib_poses)
    poses = _host(all_calib_poses)
    n = poses.shape[0]
    with metrics.span("calibrate.extrinsics.tree"):
        tree = get_camera_spanning_tree(poses, root=root)
    with metrics.span("calibrate.extrinsics.chain"):
        T = [None] * n
        T[root] = np.eye(4)
        for c1, c2 in tree:
            t_rel = estimate_pairwise_camera_transform(poses[c1], poses[c2], device=dev)
            T[c2] = _host(get_transformation_matrix(t_rel)) @ T[c1]
        all_extrinsics = np.stack(
            [_host(get_transformation_vector(_t(t, dev))) for t in T]
        )
    return all_extrinsics, tree


def consensus_calib_poses(all_calib_poses, all_extrinsics, device=None):
    """Median world-frame board pose across cameras, per frame: (F, 6)
    tensor. T_board2world = T_world2cam^-1 @ T_board2cam per camera,
    element-wise masked median of the 6-vectors across cameras."""
    with metrics.span("consensus_calib_poses"):
        dev = _pick(device, all_calib_poses, all_extrinsics)
        poses = _t(all_calib_poses, dev)  # (C, F, 6)
        ext = _t(all_extrinsics, dev)  # (C, 6)
        detected = torch.isfinite(poses).all(-1)  # (C, F)
        T_b2c = get_transformation_matrix(torch.nan_to_num(poses))
        T_w2c_inv = se3_inverse(get_transformation_matrix(ext))[:, None]
        t_b2w = get_transformation_vector(T_w2c_inv @ T_b2c)  # (C, F, 6)
        return masked_median(t_b2w, detected[..., None], axis=0)


def _reanchor_extrinsics(all_calib_poses, consensus_poses, all_extrinsics, root, device):
    """Every camera but ``root`` anchored to the rig's consensus board poses:
    its extrinsics the element-wise masked median, over the frames it shares
    with the consensus, of its own world -> camera transforms (as the repair
    anchors a re-solved camera), in place of the chain of pairwise medians
    along the spanning tree, which hands a poorly initialised camera's error
    to every camera below it in the tree. A camera that shares no frame with
    the consensus keeps ``all_extrinsics``' row. Returns (C, 6) numpy."""
    poses = _t(all_calib_poses, device)  # (C, F, 6)
    cons = _t(consensus_poses, device)  # (F, 6)
    common = torch.isfinite(poses).all(-1) & torch.isfinite(cons).all(-1)  # (C, F)
    T_w2c = get_transformation_matrix(torch.nan_to_num(poses)) @ se3_inverse(
        get_transformation_matrix(torch.nan_to_num(cons)))
    ext = _host(masked_median(get_transformation_vector(T_w2c), common[..., None], axis=1))
    given = np.asarray(all_extrinsics, dtype=float)
    ext = np.where(np.isfinite(ext), ext, given)
    ext[root] = given[root]
    return ext


def _median_reproj_err(calib_uvs, poses, K, dist, objpoints, device):
    """Median per-observation reprojection error (px) for one camera, over
    the frames with a pose (NaN uvs/poses masked)."""
    uvs = _t(calib_uvs, device)
    poses = _t(poses, device)
    cam12 = _cam12(_t(K, device), _t(dist, device).reshape(-1))
    pred = _predict(cam12[None], poses, _t(objpoints, device))[0]
    err = torch.linalg.vector_norm(uvs - pred, dim=-1)
    ok = torch.isfinite(poses).all(-1)[:, None] & torch.isfinite(uvs).all(-1)
    return float(masked_median(err.reshape(-1), ok.reshape(-1), axis=0))


def _compose_cam_poses(extrinsic6, consensus_poses, device):
    """Board->camera pose per frame: T(ext_c) @ T(consensus_f), (F, 6);
    frames without a consensus pose come out NaN."""
    cp = _t(consensus_poses, device)
    ok = torch.isfinite(cp).all(-1)
    T = get_transformation_matrix(_t(extrinsic6, device)) @ get_transformation_matrix(
        torch.nan_to_num(cp)
    )
    return torch.where(ok[:, None], get_transformation_vector(T), torch.nan)


def _rig_consistent_err(calib_uvs, extrinsic6, K, dist, consensus_poses,
                        objpoints, device):
    """Median reprojection error (px) of one camera against the rig's
    consensus board poses: the metric that exposes compensating
    single-camera fits (which look perfect under their own free poses)."""
    poses = _compose_cam_poses(extrinsic6, consensus_poses, device)
    return _median_reproj_err(calib_uvs, poses, K, dist, objpoints, device)


def _resect_camera(calib_uvs, extrinsic6, K, dist, consensus_poses, objpoints, device):
    """One camera's 12 parameters fitted to its detections, from (K, dist,
    extrinsic6) with the intrinsics' LM options, the board poses held at
    the rig's consensus (world) poses: a resection, which the other
    cameras' poses make well posed where the camera's own single-camera
    fit settled on a compensating distortion. Returns ((K, dist),
    extrinsic6) as numpy."""
    uvs = _t(calib_uvs, device)  # (F, N, 2)
    cons = _t(consensus_poses, device)  # (F, 6)
    mask = torch.isfinite(uvs).all(-1) & torch.isfinite(cons).all(-1)[:, None]
    cam0 = torch.cat([_cam12(_t(K, device), _t(dist, device).reshape(-1))[:6],
                      _t(extrinsic6, device)])[None]
    cam, _, _ = lm_solve(cam0, torch.nan_to_num(cons), torch.nan_to_num(uvs)[None], mask[None],
                         _t(objpoints, device), _intrinsics_opts(None),
                         cam_free=torch.ones_like(cam0), pose_free=torch.zeros_like(cons))
    cam = _host(cam)
    return _intrinsics_out(cam)[0], cam[0, 6:]


def _repair_bad_intrinsics(
    all_calib_uvs,
    img_sizes,
    calib_objpoints,
    all_intrinsics,
    all_calib_poses,
    all_extrinsics,
    consensus_poses,
    n_samples,
    verbose,
    device,
    resect=False,
):
    """Peer-relative init repair (in place on the intrinsics/poses lists).

    Flag cameras whose rig-consistent median error is an outlier against
    the rig median, refit them from fresh frame samples, and keep a
    candidate only if it measurably improves that camera under the same
    consensus poses. With ``resect`` a flagged camera is first resected
    against the consensus poses (:func:`_resect_camera`), and refit from
    samples only where that leaves it an outlier. Returns True if anything
    changed (the caller re-runs the extrinsics tree + consensus). Needs >= 4
    cameras.
    """
    n_cameras = len(all_intrinsics)
    if n_cameras < 4:
        metrics.count("calibrate.repair.cameras", 0)
        return False
    errs = np.array([
        _rig_consistent_err(
            all_calib_uvs[c], all_extrinsics[c], all_intrinsics[c][0],
            all_intrinsics[c][1], consensus_poses, calib_objpoints, device,
        )
        for c in range(n_cameras)
    ])
    peer = float(np.nanmedian(errs))
    thresh = max(3.0 * peer, 2.0)
    bad = ~np.isfinite(errs) | (errs > thresh)
    metrics.count("calibrate.repair.cameras", int(bad.sum()))
    changed = False
    for c in np.nonzero(bad)[0]:
        best_err = errs[c]
        samples = ((9973, n_samples), (31337, 2 * n_samples))
        if resect:
            cand, ext_c = _resect_camera(all_calib_uvs[c], all_extrinsics[c], *all_intrinsics[c],
                                         consensus_poses, calib_objpoints, device)
            e = _rig_consistent_err(all_calib_uvs[c], ext_c, cand[0], cand[1], consensus_poses,
                                    calib_objpoints, device)
            if np.isfinite(e) and e < best_err:
                all_intrinsics[c] = cand
                all_calib_poses[c] = _host(
                    estimate_pose(all_calib_uvs[c], calib_objpoints, *cand, device=device))
                best_err = e
                changed = True
                if best_err <= thresh:
                    samples = ()
        for seed, ns in samples:
            try:
                cand = get_intrinsics(
                    all_calib_uvs[c], calib_objpoints, img_sizes[c],
                    n_samples=ns, seed=seed, device=device,
                )
            except ValueError:
                break  # too few fully-detected frames to resample
            poses_c = _host(
                estimate_pose(all_calib_uvs[c], calib_objpoints, *cand, device=device)
            )
            # Re-anchor the camera to the rig: its extrinsic from the
            # median relative transform vs the consensus (world) poses.
            ext_c = _host(estimate_pairwise_camera_transform(
                consensus_poses, poses_c, device=device
            ))
            e = _rig_consistent_err(
                all_calib_uvs[c], ext_c, cand[0], cand[1], consensus_poses,
                calib_objpoints, device,
            )
            if np.isfinite(e) and e < best_err:
                all_intrinsics[c] = cand
                all_calib_poses[c] = poses_c
                best_err = e
                changed = True
            if best_err <= thresh:
                break
        if verbose:
            print(
                f"  repaired camera {c}: rig-consistent median error "
                f"{errs[c]:.2f} -> {best_err:.2f} px (rig median {peer:.2f})"
            )
    return changed


def _batched_route(uvs_arr, device):
    """Whether ``calibrate`` takes the camera-batched entry points: uniform
    (C, F, N, 2) detections on a CUDA device (the JAX package's rule is
    "off the CPU backend")."""
    return uvs_arr is not None and uvs_arr.ndim == 4 and device.type == "cuda"


def calibrate(
    all_calib_uvs,
    img_sizes,
    calib_objpoints,
    root=0,
    verbose=True,
    n_samples_for_intrinsics=100,
    device=None,
    reanchor=False,
):
    """Full initialization pipeline, with the JAX signature and returns:
    (all_extrinsics (C, 6) numpy, all_intrinsics list of (K, dist),
    consensus poses (F, 6) numpy, spanning_tree).

    Spans (``utils.metrics``): ``calibrate.intrinsics`` (with
    ``calibrate.intrinsics.zhang`` / ``.refine`` inside, which the repair's
    re-solves open too), ``calibrate.poses``, ``calibrate.extrinsics`` (with
    ``calibrate.extrinsics.tree`` / ``.chain``), ``calibrate.consensus``,
    ``calibrate.repair``; counters ``calibrate.intrinsics.lm_iters`` (the LM
    iterations the host drives: a lockstep refine counts its slowest
    camera's) and ``calibrate.repair.cameras`` (cameras the repair
    re-solves). As in the JAX package, uniform (C, F, N, 2) detections take
    the camera-batched entry points (``get_intrinsics_batch``,
    ``estimate_pose_batch``) on an accelerator (here a CUDA device,
    :func:`_batched_route`), where per-camera dispatch dominates; on the CPU
    each camera is solved on its own.

    ``reanchor`` (a port-side option, off by default; the JAX package
    chains along the tree): after the consensus, and again after a repair,
    every camera but the root takes its extrinsics from its own board poses
    against the consensus poses (:func:`_reanchor_extrinsics`), and the
    consensus is taken once more (span ``calibrate.reanchor``); and the
    repair resects a flagged camera against the consensus poses before it
    resamples. On a 64-camera stage the tree can hang several cameras below
    one whose intrinsics came out poorly (a compensating-distortion fit);
    chained, they inherit its error (40-57 mm, 14-44 px), the repair then
    re-solves their intrinsics for nothing, and ``bundle_adjust``'s outlier
    rule, on each frame's worst camera, drops nearly every frame; the poor
    camera itself, refit from fresh samples, can stay ~10 px and 0.4 rad
    off, and ``bundle_adjust`` leaves it in that basin.
    """
    dev = _pick(device, all_calib_uvs)
    n_cameras = len(all_calib_uvs)
    try:
        uvs_arr = np.asarray(all_calib_uvs, dtype=float)
    except (ValueError, TypeError):  # ragged per-camera input, or tensors
        uvs_arr = None
    batched = _batched_route(uvs_arr, dev)
    if verbose:
        print("Estimating camera intrinsics")
    with metrics.span("calibrate.intrinsics", n_cameras=n_cameras):
        if batched:
            all_intrinsics = get_intrinsics_batch(
                uvs_arr, calib_objpoints, img_sizes,
                n_samples=n_samples_for_intrinsics, device=dev,
            )
        else:
            all_intrinsics = [
                get_intrinsics(
                    all_calib_uvs[c], calib_objpoints, img_sizes[c],
                    n_samples=n_samples_for_intrinsics, device=dev,
                )
                for c in range(n_cameras)
            ]
    if verbose:
        print("Initializing calibration object poses")
    with metrics.span("calibrate.poses"):
        if batched:
            # np.array (a copy): _repair_bad_intrinsics writes rows in place.
            all_calib_poses = np.array(_host(estimate_pose_batch(
                uvs_arr, calib_objpoints,
                [k for k, _ in all_intrinsics], [d for _, d in all_intrinsics],
                device=dev,
            )))
        else:
            all_calib_poses = np.stack([
                _host(estimate_pose(all_calib_uvs[c], calib_objpoints,
                                    *all_intrinsics[c], device=dev))
                for c in range(n_cameras)
            ])
    if verbose:
        print("Estimating camera extrinsics")
    with metrics.span("calibrate.extrinsics"):
        all_extrinsics, spanning_tree = estimate_all_extrinsics(
            all_calib_poses, root=root, device=dev
        )
    if verbose:
        print("Merging calibration object poses")
    with metrics.span("calibrate.consensus"):
        calib_poses = _host(consensus_calib_poses(all_calib_poses, all_extrinsics,
                                                  device=dev))

    def anchored(all_extrinsics, calib_poses):
        if not reanchor:
            return all_extrinsics, calib_poses
        with metrics.span("calibrate.reanchor"):
            ext = _reanchor_extrinsics(all_calib_poses, calib_poses, all_extrinsics, root,
                                       dev)
            return ext, _host(consensus_calib_poses(all_calib_poses, ext, device=dev))

    all_extrinsics, calib_poses = anchored(all_extrinsics, calib_poses)
    # Rig-consistency check + single-camera init repair (needs the
    # consensus poses). On repair, re-anchor the tree and consensus once.
    with metrics.span("calibrate.repair"):
        all_intrinsics = list(all_intrinsics)
        if _repair_bad_intrinsics(
            all_calib_uvs, img_sizes, calib_objpoints, all_intrinsics,
            all_calib_poses, all_extrinsics, calib_poses,
            n_samples_for_intrinsics, verbose, dev, resect=reanchor,
        ):
            all_extrinsics, spanning_tree = estimate_all_extrinsics(
                all_calib_poses, root=root, device=dev
            )
            calib_poses = _host(consensus_calib_poses(
                all_calib_poses, all_extrinsics, device=dev
            ))
            all_extrinsics, calib_poses = anchored(all_extrinsics, calib_poses)
    return all_extrinsics, all_intrinsics, calib_poses, spanning_tree
