"""Bundle adjustment: the JAX package's public API over the Schur LM engine.

Counterpart of ``multicam_calibration_tpu/models/bundle_adjustment.py``:
the same parameter layout, the same outlier/frame-selection semantics and
return structure, with :mod:`.lm_core` as the solver. ``bundle_adjust``
runs on one device, or with ``mesh`` frame-sharded over the processes of a
``torch.distributed`` device mesh (:mod:`..parallel`).

Entry points that take numpy input run on ``device``: None means the CUDA
device (raising without one); pass ``device="cpu"`` for the CPU.

Parameter layout (the reference's): per camera
[fx, fy, cx, cy, k1, k2, rx, ry, rz, tx, ty, tz], then F x 6 board poses.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..device import cuda_device, resolve_device, with_highest_precision
from ..ops.projection import project_points
from ..ops.reductions import masked_mean, nanmedian
from ..ops.transforms import euclidean_to_homogenous, get_transformation_matrix
from ..utils.metrics import metrics
from .initialize import _host as _np
from .lm_core import (HIST_FIELDS, LMOptions, accelerator_recipe, compute_cost, compute_residuals,
                      lm_solve)

__all__ = [
    "embed_calib_objpoints",
    "predict_calib_uvs",
    "residuals",
    "bundle_adjustment_sparsity",
    "serialize_params",
    "deserialize_params",
    "select_ba_frames",
    "bundle_adjust",
]


def _as_tensor(x, like=None, device=None):
    """A tensor as given; else on ``like``'s device in its dtype, or f64 on
    ``device`` (None: the CUDA device, which raises without one)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)
    if device is None:
        device = cuda_device()
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def embed_calib_objpoints(calib_objpoints, calib_poses, device=None):
    """Board canonical points -> world coords per frame: (F, N, 3).

    A tensor ``calib_poses`` keeps its device and dtype; numpy poses go to
    ``device`` in f64 (None: the CUDA device; pass "cpu" for the CPU).
    """
    poses = _as_tensor(calib_poses, device=device)
    objp = _as_tensor(calib_objpoints, poses)
    T = get_transformation_matrix(poses)[:, None]
    pts = euclidean_to_homogenous(objp)[None, :, :, None]
    return (T @ pts)[..., :3, 0]


def predict_calib_uvs(all_extrinsics, all_intrinsics, calib_objpoints, calib_poses,
                      device=None):
    """Forward model for every camera: (C, F, N, 2), in the dtype and on the
    device of ``calib_poses`` when it is a tensor, else f64 on ``device``
    (None: the CUDA device; pass "cpu" for the CPU)."""
    pts = embed_calib_objpoints(calib_objpoints, calib_poses, device)
    preds = [
        project_points(
            pts,
            _as_tensor(all_extrinsics[i], pts),
            _as_tensor(all_intrinsics[i][0], pts),
            _as_tensor(all_intrinsics[i][1], pts),
        )
        for i in range(len(all_extrinsics))
    ]
    return torch.stack(preds)


def serialize_params(all_extrinsics, all_intrinsics, calib_poses):
    """Flatten to the reference layout (numpy)."""
    x0 = []
    for transform, (camera_matrix, dist_coefs) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(camera_matrix)
        x0.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist_coefs).reshape(-1)[:2],
                    np.asarray(transform).reshape(-1),
                ]
            )
        )
    x0.append(np.asarray(calib_poses).reshape(-1))
    return np.concatenate(x0)


def deserialize_params(x, n_cameras):
    """Inverse of :func:`serialize_params`; dist coefs are zero-padded to 5
    (k1, k2 only are optimized)."""
    x = np.asarray(x)
    all_extrinsics, all_intrinsics = [], []
    for i in range(n_cameras):
        fx, fy, cx, cy = x[i * 12 : i * 12 + 4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        dist = np.pad(x[i * 12 + 4 : i * 12 + 6], (0, 3))
        all_extrinsics.append(x[i * 12 + 6 : i * 12 + 12])
        all_intrinsics.append((K, dist))
    calib_poses = x[n_cameras * 12 :].reshape(-1, 6)
    return np.array(all_extrinsics), all_intrinsics, calib_poses


def _params_to_arrays(all_extrinsics, all_intrinsics):
    """(C, 12) cam-param matrix in the reference layout (numpy)."""
    rows = []
    for ext, (K, dist) in zip(all_extrinsics, all_intrinsics):
        K = np.asarray(K)
        rows.append(
            np.concatenate(
                [
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                    np.asarray(dist).reshape(-1)[:2],
                    np.asarray(ext).reshape(-1),
                ]
            )
        )
    return np.stack(rows)


def _arrays_to_params(cam):
    """(C, 12) cam-param matrix (numpy or tensor) -> (extrinsics, intrinsics)."""
    if isinstance(cam, torch.Tensor):
        cam = cam.detach().cpu().numpy()
    cam = np.asarray(cam)
    all_extrinsics = cam[:, 6:12]
    all_intrinsics = []
    for row in cam:
        K = np.array([[row[0], 0, row[2]], [0, row[1], row[3]], [0, 0, 1.0]])
        all_intrinsics.append((K, np.array([row[4], row[5], 0.0, 0.0, 0.0])))
    return all_extrinsics, all_intrinsics


def residuals(params, all_calib_uvs, calib_objpoints, device=None):
    """Flat masked residual vector (obs - pred)[~isnan(obs)] (numpy), the
    forward model on ``device`` (None: the CUDA device)."""
    all_calib_uvs = np.asarray(all_calib_uvs)
    ext, intr, poses = deserialize_params(params, all_calib_uvs.shape[0])
    pred = _np(predict_calib_uvs(ext, intr, calib_objpoints, poses, device=device))
    return (all_calib_uvs - pred)[~np.isnan(all_calib_uvs)]


def bundle_adjustment_sparsity(all_calib_uvs):
    """Jacobian sparsity pattern (scipy.sparse), for interop/debugging.

    The solver never materializes this matrix; it exists so reference-style
    workflows (handing the problem to scipy) keep working. Host-only.
    """
    from scipy.sparse import lil_matrix

    all_calib_uvs = np.asarray(all_calib_uvs)
    n_cameras, n_frames, N, _ = all_calib_uvs.shape
    n_params = n_cameras * 12 + n_frames * 6
    mask = ~np.isnan(all_calib_uvs)
    cam_ixs = np.broadcast_to(
        np.arange(n_cameras)[:, None, None, None], all_calib_uvs.shape
    )[mask]
    frame_ixs = np.broadcast_to(
        np.arange(n_frames)[None, :, None, None], all_calib_uvs.shape
    )[mask]
    A = lil_matrix((int(mask.sum()), n_params), dtype=int)
    i = np.arange(int(mask.sum()))
    for s in range(12):
        A[i, cam_ixs * 12 + s] = 1
    for s in range(6):
        A[i, n_cameras * 12 + frame_ixs * 6 + s] = 1
    return A


def _upload(all_calib_uvs, device):
    """The detections as an f64 tensor on ``device`` (a tensor as given).
    To a CUDA device they go through a pinned staging copy: for stage64.ba's
    0.72 GB, 0.05 s on an H100 once the host allocator holds the block,
    against 0.13 s from pageable memory."""
    if isinstance(all_calib_uvs, torch.Tensor):
        return all_calib_uvs
    dev = resolve_device(device)
    host = torch.from_numpy(np.asarray(all_calib_uvs, np.float64))
    if dev.type != "cuda":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def _read_back(t):
    """numpy copy of tensor ``t``, its bytes added to the counter
    ``ba.readback_bytes``."""
    metrics.count("ba.readback_bytes", t.numel() * t.element_size())
    return _np(t)


def _frame_errors(err):
    """Per-frame statistics of point errors ``err`` (C, F, N), NaN where a
    point is not observed, reduced on err's device in its dtype.

    Returns (worst, mean), each (F,): ``worst`` is the largest per-camera
    mean error, 0 where no camera observes a point of the frame (numpy's
    ``nan_to_num(nanmax(nanmean(err, -1), 0))``); ``mean`` is the mean over
    every camera and point, NaN where none is observed
    (``nanmean(err, (0, 2))``).
    """
    seen = ~torch.isnan(err)
    cam_mean = masked_mean(err, seen, axis=-1)  # (C, F)
    worst = torch.where(torch.isnan(cam_mean), -torch.inf, cam_mean).amax(0)
    worst = torch.where(worst == -torch.inf, 0.0, worst)
    return worst, masked_mean(err, seen, axis=(0, 2))


def _select_frames(all_calib_uvs, all_extrinsics, all_intrinsics, calib_objpoints,
                   calib_poses, n_frames, outlier_threshold, seed, verbose, device):
    """:func:`select_ba_frames`, also returning the detections as the f64
    tensor the statistics were reduced from (on ``device``)."""
    with metrics.span("ba.select_frames.predict"):
        uvs = _upload(all_calib_uvs, device)
        full = ~torch.isnan(uvs).any(-1).any(-1)  # (C, F_all): seen whole
        two_cam = full.sum(0) > 1
        frames = torch.nonzero(two_cam)[:, 0]
        pred = predict_calib_uvs(all_extrinsics, all_intrinsics, calib_objpoints,
                                 _as_tensor(calib_poses, uvs)[frames])
        err = torch.linalg.vector_norm(uvs[:, frames] - pred, dim=-1)  # NaN: unobserved
        worst, _ = _frame_errors(err)
        threshold = outlier_threshold
        if threshold is None:
            threshold = float(_read_back(5 * nanmedian(err.reshape(-1))))
        keep = torch.zeros_like(two_cam)
        keep[frames] = ~(worst > threshold)
        two_cam, keep = _read_back(torch.stack([two_cam, keep]))
    with metrics.span("ba.select_frames.host"):
        use_frames = np.nonzero(keep)[0]
        if verbose:
            print(
                f"Excluding {int(two_cam.sum() - keep.sum())} out of {len(use_frames)} "
                f"frames based on an outlier threshold of {threshold}"
            )
        if n_frames is not None and n_frames < len(use_frames):
            rng = np.random.default_rng(seed)
            use_frames = np.sort(rng.choice(use_frames, n_frames, replace=False))
    return use_frames, uvs


def select_ba_frames(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    n_frames=10000,
    outlier_threshold=None,
    seed=0,
    verbose=True,
    device=None,
):
    """Frame selection for BA: >=2-camera frames minus outliers, subsampled.

    Frames fully detected by >= 2 cameras; drop frames whose worst
    per-camera mean reprojection error exceeds ``outlier_threshold``
    (default 5 x median error at the initial parameters, numpy's median:
    the mean of the two middle errors on an even count); random-subsample
    to ``n_frames`` with ``numpy.random.default_rng(seed)``.

    Numpy detections go to ``device`` (None: the CUDA device) once, in f64;
    a tensor is used where it is. The forward model, the errors and their
    reductions run there; only per-frame flags and the threshold come back
    to the host, which draws the subsample. Returns a numpy index array.
    """
    return _select_frames(all_calib_uvs, all_extrinsics, all_intrinsics, calib_objpoints,
                          calib_poses, n_frames, outlier_threshold, seed, verbose, device)[0]


def _emit_lm_history(info, verbose):
    """Per-iteration optimizer telemetry (scipy verbose=2 parity): logged as
    ``ba_lm_iter`` metrics events and printed as a table when ``verbose``."""
    hist = info.get("history")
    if hist is None:
        return
    hist = _np(hist)
    n = min(int(info["n_iters"]), hist.shape[0])
    for i in range(n):
        metrics.log(
            "ba_lm_iter",
            it=i,
            **{k: float(v) for k, v in zip(HIST_FIELDS, hist[i])},
        )
    if verbose and n:
        print(
            f"{'iter':>5} {'cost':>14} {'grad_norm':>11} {'step_norm':>11} "
            f"{'lambda':>9} {'tries':>5}"
        )
        for i in range(n):
            c, g, s, lam, t, _ = hist[i]
            print(
                f"{i:>5} {c:>14.6e} {g:>11.3e} {s:>11.3e} {lam:>9.2e} "
                f"{int(t):>5}"
            )


def _ba_fingerprint(all_calib_uvs, seed, n_frames, outlier_threshold):
    """Content hash identifying a BA problem for checkpoint validation: the
    detection data (as f64 bytes) plus every option that shapes the frame
    selection. The JAX package writes and checks the same hash."""
    h = hashlib.sha1()
    arr = np.ascontiguousarray(np.asarray(all_calib_uvs, dtype=np.float64))
    h.update(arr.tobytes())
    h.update(repr((seed, n_frames, outlier_threshold)).encode())
    return h.hexdigest()


def _mean_frame_errors(cam, poses, obs, mask, objpoints):
    """(F,) mean reprojection error of each frame over its observed points,
    NaN where none is observed, on the device of the inputs."""
    err = torch.linalg.vector_norm(compute_residuals(cam, poses, obs, mask, objpoints), dim=-1)
    return _frame_errors(torch.where(mask, err, torch.nan))[1]


def _repair_bad_poses(cam, poses, obs, mask, objpoints, opts, threshold=5.0):
    """Re-solve frame poses the robust LM left in a bad basin.

    Flag frames whose mean reprojection error exceeds ``threshold`` x
    median (numpy's median over frames, reduced on the device; only the
    (F,) flags come back), re-initialize their poses from per-camera planar
    PnP + consensus at the refined cameras, then polish only those poses
    (cameras and healthy poses frozen through ``cam_free``/``pose_free``;
    on CUDA with the f32 recipe the polish runs through the kernels with
    the pose mask). A repaired pose replaces the original only where it
    lowers that frame's error. Returns (poses, n_repaired).
    """
    from .initialize import consensus_calib_poses, estimate_pose

    dev, dtype = poses.device, poses.dtype
    with metrics.span("ba.pose_repair.flag"):
        per_frame = _mean_frame_errors(cam, poses, obs, mask, objpoints)
        bad_t = torch.nan_to_num(per_frame, nan=0.0) > threshold * nanmedian(per_frame)
        bad = _read_back(bad_t)
    metrics.count("ba.pose_repair.flagged", int(bad.sum()))
    if not bad.any():
        return poses, 0

    # Fresh PnP init for the bad frames at the refined camera parameters.
    with metrics.span("ba.pose_repair.reinit"):
        ext, intr = _arrays_to_params(cam.to(torch.float64))
        bad_ix = np.nonzero(bad)[0]
        rows = torch.as_tensor(bad_ix, device=dev)
        obs_nan = np.where(_np(mask[:, rows])[..., None], _np(obs[:, rows].to(torch.float64)),
                           np.nan)
        all_poses = np.stack([
            _np(estimate_pose(obs_nan[c], objpoints, *intr[c], device=dev))
            for c in range(len(ext))
        ])
        reinit = _np(consensus_calib_poses(all_poses, ext, device=dev))
        poses_np = _np(poses).copy()
        ok = ~np.isnan(reinit).any(-1)
        poses_np[bad_ix[ok]] = reinit[ok]

    with metrics.span("ba.pose_repair.solve"):
        pose_free = torch.zeros((poses_np.shape[0], 6), dtype=dtype, device=dev)
        pose_free[rows] = 1.0
        cam_free = torch.zeros((cam.shape[0], 12), dtype=dtype, device=dev)
        _, poses2, _ = lm_solve(
            cam, torch.as_tensor(np.nan_to_num(poses_np), dtype=dtype, device=dev),
            obs, mask, objpoints, opts, cam_free=cam_free, pose_free=pose_free,
        )
        per_frame2 = _mean_frame_errors(cam, poses2, obs, mask, objpoints)
        improved = bad_t & (torch.nan_to_num(per_frame2, nan=torch.inf) < per_frame)
        return torch.where(improved[:, None], poses2, poses), int(improved.sum())


# LMOptions fields a bundle_adjust keyword (or a dict ``lm_options``) may set,
# with the JAX defaults where the recipe sets none. JAX forwards all of them
# but ``block_impl``; the port forwards that too, so a caller can ask for the
# plain path.
_FORWARDED = ("ftol", "loss", "f_scale", "max_iters", "jac_dtype", "block_dtype",
              "cost_dtype", "solve_dtype", "grad_dtype", "gtol_rel",
              "lambda_escalation", "frame_chunk", "cost_impl", "block_impl")


@with_highest_precision
def bundle_adjust(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    n_frames=10000,
    outlier_threshold=None,
    dtype=None,
    lm_options=None,
    mesh=None,
    seed=0,
    verbose=True,
    checkpoint_path=None,
    checkpoint_every=None,
    repair_poses=True,
    device=None,
    **opt_kwargs,
):
    """Joint refinement of camera params + board poses (reference parity API).

    Frames observed by >= 2 cameras; frames whose worst per-camera mean
    reprojection error exceeds ``outlier_threshold`` (default 5 x median
    error) excluded; random subsample to ``n_frames``; then LM with soft-L1
    loss and ftol=1e-4.

    Numerics: ``dtype=None`` is float64 (torch has f64 on every device). On
    a CUDA device the JAX package's accelerator recipe applies: f32
    Jacobians, blocks, Schur solve, per-observation products and per-try
    cost, ``gtol_rel=1e-6``, ``lambda_escalation=3.0``; that recipe routes
    the main solve through both CUDA kernels (block build, per-try cost).
    On the CPU only ``jac_dtype="float32"``, as in JAX. After a
    mixed-precision solve a short f64 polish (``max_iters=10``) runs on the
    same device in native f64 (``info["polish_on_cpu"]`` is always False).

    ``mesh`` (a 1-D ``DeviceMesh`` from :func:`..parallel.make_frame_mesh`;
    every rank calls with the same arguments) shards the frames of the
    solve and of the f64 polish over its processes
    (:func:`..parallel.sharded_lm_solve`); every rank returns the same
    result. Pose repair is skipped on a mesh (logged as
    ``ba_pose_repair_skipped``): its polish would run unsharded.

    Checkpoint/resume: with ``checkpoint_path`` set, the optimizer state
    (params, damping, iteration count, frame selection) is saved as .npz
    every ``checkpoint_every`` iterations (default 10) and a killed run
    resumes from the file, guarded by the content fingerprint. The file
    format and fingerprint are the JAX package's, so a checkpoint resumes
    in either package. On a mesh only rank 0 writes the file, and every
    rank reads it.

    The detections go to the device once, in f64; the frame selection,
    the solve's inputs and the pose repair's flag are computed there, and
    only per-frame vectors and scalars come back (the counter
    ``ba.readback_bytes``). A resumed call uploads them in ``ba.prepare``.

    Spans (``utils.metrics``): ``ba.select_frames`` (with
    ``ba.select_frames.predict``: the upload, the forward model, the
    error reductions and the read of the per-frame flags; ``.host``: the
    subsample and the message), ``ba.prepare``, ``ba.lm_solve``,
    ``ba.f64_polish``, ``ba.pose_repair`` (with ``ba.pose_repair.flag`` /
    ``.reinit`` / ``.solve`` inside, and the counter
    ``ba.pose_repair.flagged``).

    Returns (adjusted_extrinsics, adjusted_intrinsics, adjusted_calib_poses,
    use_frames, result_info), all numpy.
    """
    dev = resolve_device(device)
    writes_checkpoint = True
    if mesh is not None and checkpoint_path is not None:
        from ..parallel.collectives import all_reduce, rank_and_size

        writes_checkpoint = rank_and_size(mesh)[0] == 0
        # Orders this read after rank 0's writes of an earlier call.
        all_reduce(torch.zeros(1, device=dev), mesh)
    all_calib_uvs = np.asarray(all_calib_uvs)
    n_cameras = all_calib_uvs.shape[0]

    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"  # np.savez appends it; keep load in sync
    ckpt = None
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = _ba_fingerprint(all_calib_uvs, seed, n_frames, outlier_threshold)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ckpt = dict(np.load(checkpoint_path))
        if ckpt["n_cameras"] != n_cameras or ckpt["n_total_frames"] != (
            all_calib_uvs.shape[1]
        ):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different "
                "problem (camera/frame counts differ)"
            )
        if "fingerprint" in ckpt and str(np.asarray(ckpt["fingerprint"])) != fingerprint:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different "
                "problem (detection data or frame-selection options differ); "
                "delete it or pass a different checkpoint_path"
            )
        if verbose:
            print(
                f"Resuming BA from {checkpoint_path} "
                f"(iteration {int(ckpt['it_done'])})"
            )

    if ckpt is not None:
        use_frames = ckpt["use_frames"]
    else:
        with metrics.span("ba.select_frames"):
            use_frames, uvs = _select_frames(
                all_calib_uvs, all_extrinsics, all_intrinsics, calib_objpoints,
                calib_poses, n_frames, outlier_threshold, seed, verbose, dev,
            )

    with metrics.span("ba.prepare"):
        if ckpt is not None:  # a resumed call made no selection
            uvs = _upload(all_calib_uvs, dev)
        frames = torch.as_tensor(use_frames, device=dev)
        obs64 = uvs[:, frames]
        del uvs  # the whole upload is not held through the solve
        if ckpt is not None:
            cam0, poses0 = ckpt["cam"], torch.as_tensor(ckpt["poses"], device=dev)
        else:
            cam0 = _params_to_arrays(all_extrinsics, all_intrinsics)
            poses0 = _as_tensor(calib_poses, device=dev)[frames]

        # Numerics defaults (see lm_core.LMOptions): f64 data + f32 Jacobians
        # everywhere; off the CPU also the JAX package's accelerator recipe.
        default_jac_dtype = None
        default_f32 = {}
        if dtype is None:
            dtype = torch.float64
            default_jac_dtype = "float32"
            default_f32 = accelerator_recipe(dev)
        elif isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
        obs = torch.nan_to_num(obs64).to(dtype)
        mask = ~torch.isnan(obs64).any(-1)  # (C, F, N) per-point mask
        del obs64
        cam0_t = as_t(cam0)
        poses0_t = torch.nan_to_num(poses0).to(dtype)
        objpoints = as_t(calib_objpoints)

        if isinstance(lm_options, dict):
            # A dict of LMOptions overrides is layered on the auto-selected
            # recipe (an LMOptions instance replaces the recipe wholesale).
            opt_kwargs = {**opt_kwargs, **lm_options}
            lm_options = None
        defaults = dict(ftol=1e-4, loss="soft_l1", f_scale=1.0, max_iters=100,
                        jac_dtype=default_jac_dtype, gtol_rel=0.0,
                        lambda_escalation=1.0)
        defaults.update(default_f32)
        opts = lm_options or LMOptions(**{
            k: opt_kwargs[k] if k in opt_kwargs else defaults[k]
            for k in _FORWARDED if k in opt_kwargs or k in defaults
        })

        def _solve(cam_in, poses_in, chunk_opts, init_lam=None, init_grad0=None):
            if mesh is not None:
                from ..parallel.sharded import sharded_lm_solve

                return sharded_lm_solve(cam_in, poses_in, obs, mask, objpoints, chunk_opts,
                                        mesh=mesh, init_lam=init_lam, init_grad0=init_grad0)
            return lm_solve(cam_in, poses_in, obs, mask, objpoints, chunk_opts,
                            init_lam=init_lam, init_grad0=init_grad0)

    with metrics.span("ba.lm_solve", n_cameras=n_cameras, n_frames=len(use_frames),
                      sharded=mesh is not None):
        if checkpoint_path is None:
            cam, poses, info = _solve(cam0_t, poses0_t, opts)
        else:
            every = int(checkpoint_every or 10)
            it_done = int(ckpt["it_done"]) if ckpt is not None else 0
            lam = float(ckpt["lam"]) if ckpt is not None else None
            # grad0 anchors the gtol_rel stop to the first linearization of
            # the whole optimization; -1.0 is the "unset" sentinel.
            grad0 = (float(ckpt["grad0"]) if ckpt is not None and "grad0" in ckpt
                     else None)
            if grad0 is not None and grad0 < 0:
                grad0 = None
            cam, poses = cam0_t, poses0_t
            first_cost = float(ckpt["initial_cost"]) if ckpt is not None else None
            ran_any = False
            info = {}
            while it_done < opts.max_iters:
                ran_any = True
                chunk_opts = dataclasses.replace(
                    opts, max_iters=min(every, opts.max_iters - it_done)
                )
                cam, poses, info = _solve(cam, poses, chunk_opts, init_lam=lam,
                                          init_grad0=grad0)
                it_done += int(info["n_iters"])
                lam = float(info["lambda"])
                grad0 = float(info["grad0"])
                if first_cost is None:
                    first_cost = float(info["initial_cost"])
                if writes_checkpoint:
                    # Atomic write: a kill mid-savez must not corrupt the file.
                    tmp_path = checkpoint_path + ".tmp.npz"
                    np.savez(
                        tmp_path,
                        cam=_np(cam),
                        poses=_np(poses),
                        lam=lam,
                        it_done=it_done,
                        use_frames=np.asarray(use_frames),
                        initial_cost=first_cost,
                        grad0=-1.0 if grad0 is None else grad0,
                        n_cameras=n_cameras,
                        n_total_frames=all_calib_uvs.shape[1],
                        fingerprint=fingerprint,
                        converged=bool(info["converged"]),
                    )
                    os.replace(tmp_path, checkpoint_path)
                metrics.log("ba_checkpoint", path=checkpoint_path, it_done=it_done,
                            cost=float(info["final_cost"]))
                if bool(info["converged"]):
                    break
            if not ran_any:  # resumed at/over the iteration cap
                cost_now = float(compute_cost(cam, poses, obs, mask, objpoints, opts))
                info = {
                    "final_cost": cost_now,
                    "converged": False,
                    "lambda": lam if lam is not None else opts.init_lambda,
                }
                if first_cost is None:
                    first_cost = cost_now
            info = dict(info)
            info["n_iters"] = it_done
            info["initial_cost"] = first_cost

    # f64 polish after a mixed-precision descent: the f32 Schur solve can
    # stall a few percent above the optimum on small or ill-conditioned
    # problems. A short warm-started f64 solve from the mixed solution, on
    # the same device (native f64 on the card).
    if (
        opts.solve_dtype is not None
        and cam0_t.dtype == torch.float64
        and getattr(torch, opts.solve_dtype) != torch.float64
    ):
        polish_opts = dataclasses.replace(
            opts, block_dtype=None, cost_dtype=None, solve_dtype=None,
            grad_dtype=None, max_iters=10,
        )
        with metrics.span("ba.f64_polish", on_cpu=False):
            cam, poses, pinfo = _solve(cam, poses, polish_opts,
                                       init_lam=float(info["lambda"]))
        info = dict(info)
        info["polish_iters"] = int(pinfo["n_iters"])
        info["polish_on_cpu"] = False
        info["final_cost"] = pinfo["final_cost"]
        info["optimality"] = pinfo["optimality"]
        metrics.log("ba_f64_polish", iters=int(pinfo["n_iters"]),
                    cost=float(pinfo["final_cost"]))

    _emit_lm_history(info, verbose)

    if repair_poses and mesh is not None:
        # The repair's polish runs unsharded: it would hold every frame's W
        # blocks on one device, which sharding exists to avoid.
        metrics.log("ba_pose_repair_skipped", reason="mesh")
        repair_poses = False
    if repair_poses:
        with metrics.span("ba.pose_repair"):
            poses, n_repaired = _repair_bad_poses(cam, poses, obs, mask, objpoints, opts)
            if n_repaired:
                info = dict(info)
                info["final_cost"] = float(
                    compute_cost(cam, poses, obs, mask, objpoints, opts)
                )
                info["n_poses_repaired"] = n_repaired
                if verbose:
                    print(f"Re-solved {n_repaired} outlier frame poses")

    adjusted_extrinsics, adjusted_intrinsics = _arrays_to_params(cam)
    adjusted_calib_poses = _np(poses)
    result = {k: _np(v) for k, v in info.items()}
    metrics.log(
        "ba_result",
        initial_cost=float(result["initial_cost"]),
        final_cost=float(result["final_cost"]),
        n_iters=int(result["n_iters"]),
        n_cameras=n_cameras,
        n_frames=len(use_frames),
    )
    if verbose:
        print(
            f"BA: cost {float(result['initial_cost']):.4g} -> "
            f"{float(result['final_cost']):.4g} in {int(result['n_iters'])} iters"
        )
    return (
        adjusted_extrinsics,
        adjusted_intrinsics,
        adjusted_calib_poses,
        use_frames,
        result,
    )
