"""Rolling re-calibration: windowed BA over a stream of frame batches.

Counterpart of ``multicam_calibration_tpu/models/streaming.py``
(BASELINE.json config 4, "Rolling re-calibration stream"). The keyframe
window has a fixed capacity and lives on the device. Each
``update(batch_uvs)``:

1. initializes the new frames' board poses by planar PnP against the
   current cameras, batched over all cameras
   (:func:`.initialize._batched_estimate_pose`), and takes their consensus
   across cameras;
2. admits them to the window, evicting the lowest-value keyframes (value =
   sum over camera pairs of 1/pair_coverage, so the rare witnesses of a
   camera pair are protected; recent frames are always protected);
3. runs a few warm-started LM iterations on the window (damping carried
   across updates via ``init_lam``) and re-estimates the cameras.

On the CUDA device an f64 window takes the JAX package's accelerator
recipe (f32 Jacobians, blocks, per-observation products, cost and Schur
solve, ``lambda_escalation=3.0``), so every LM iteration builds its blocks
through ``ba_blocks_kernel`` and every cost evaluation runs
``ba_cost_kernel``. On the CPU the solve is plain f64, as in JAX.

What the JAX version does for the TPU, and where it went here: pose init
and the consensus run on the calibrator's device (JAX pins them to the CPU
because XLA:TPU has no f64 LU); only the admitted rows are scattered into
the window (JAX pads the batch to a power of two and drops out-of-bounds
slots, for static shapes); there is no per-batch-size program cache and no
buffer donation (the window tensors are updated in place).

Profiler ranges: ``rolling.pose_init`` (ending in the one host read of the
new poses), ``rolling.admit`` (host eviction), ``rolling.scatter`` and
``rolling.lm_solve`` (ending in the one host read of the cameras).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from .bundle_adjustment import _arrays_to_params, _params_to_arrays
from .initialize import _batched_estimate_pose, consensus_calib_poses
from .lm_core import LMOptions, accelerator_recipe, lm_solve

__all__ = ["RollingCalibrator"]


def _window_options(dtype, device, iters_per_update):
    """LMOptions of the windowed solve: ``iters_per_update`` iterations, no
    ftol or gradient stop. The JAX package's accelerator recipe (its
    streaming.py:94-109; ``lm_core.accelerator_recipe``) applies to an f64
    window off the CPU."""
    recipe = accelerator_recipe(device, gtol_rel=0.0) if dtype == torch.float64 else {}
    return LMOptions(max_iters=int(iters_per_update), ftol=0.0, **recipe)


class RollingCalibrator:
    """Windowed streaming re-calibration over incoming frame batches.

    Keeps a fixed-capacity keyframe window on the device; ``update(batch_uvs)``
    initializes the new frames' board poses against the current cameras,
    admits them (evicting the lowest-value keyframes) and runs a few
    warm-started LM iterations. ``device``: None means the CUDA device
    (raising without one); pass "cpu" for the CPU. ``dtype`` defaults to
    float64.
    """

    def __init__(
        self,
        all_extrinsics,
        all_intrinsics,
        calib_objpoints,
        window=256,
        iters_per_update=3,
        protect_recent=32,
        refine_intrinsics=False,
        dtype=None,
        lm_options=None,
        device=None,
    ):
        # refine_intrinsics=False by default: rig drift is geometric, and with
        # a small window free intrinsics trade off against depth.
        self.device = resolve_device(device)
        self._ext = np.asarray(all_extrinsics, np.float64)
        self._intr = [
            (np.asarray(K, np.float64), np.asarray(d, np.float64))
            for K, d in all_intrinsics
        ]
        self.objpoints = np.asarray(calib_objpoints, np.float64)
        self.window = int(window)
        self.protect_recent = int(protect_recent)
        n_cameras = self._ext.shape[0]
        N = self.objpoints.shape[0]
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self._dtype = dtype or torch.float64
        self._opts = lm_options or _window_options(self._dtype, self.device,
                                                   iters_per_update)
        cam_free = np.ones((n_cameras, 12), np.float32)
        if not refine_intrinsics:
            cam_free[:, :6] = 0.0
        dev, dt = self.device, self._dtype
        self._cam_free = torch.as_tensor(cam_free, dtype=dt, device=dev)
        # The window on the device (obs, per-point masks, poses); the host
        # keeps only what eviction reads: per-(camera, slot) visibility and
        # arrival order.
        self._obs_d = torch.zeros((n_cameras, self.window, N, 2), dtype=dt, device=dev)
        self._msk_d = torch.zeros((n_cameras, self.window, N), dtype=torch.bool, device=dev)
        self._poses_d = torch.zeros((self.window, 6), dtype=dt, device=dev)
        self._objp_d = torch.as_tensor(self.objpoints, dtype=dt, device=dev)
        self._seen2d = np.zeros((n_cameras, self.window), bool)
        self._order = np.full(self.window, -1, dtype=np.int64)  # arrival idx
        self._next_arrival = 0
        self._lam = None
        self.n_updates = 0

    # -- public state ------------------------------------------------------
    @property
    def n_cameras(self):
        return self._ext.shape[0]

    def calibration(self):
        """Current (all_extrinsics, all_intrinsics)."""
        return self._ext.copy(), [(K.copy(), d.copy()) for K, d in self._intr]

    @property
    def occupancy(self):
        return int((self._order >= 0).sum())

    # -- internals -----------------------------------------------------------
    def _frame_values(self):
        """Keyframe value: rare camera-pair witnesses are precious.

        Vectorized over all C*(C-1)/2 pairs at once (the per-pair Python
        loop was O(C^2) interpreter iterations per update — 2016 at 64
        cameras); peak temp is the (P, W) co-visibility table, ~0.5 MB at
        64 cams x window 256.
        """
        so = self._seen2d & (self._order >= 0)[None, :]
        a, b = np.triu_indices(so.shape[0], k=1)
        co = so[a] & so[b]  # (P, W)
        counts = co.sum(1)
        nz = counts > 0
        if not nz.any():
            return np.zeros(self.window)
        return (co[nz] / counts[nz, None]).sum(0)

    def _evict_slots(self, n_needed):
        """Pick distinct slots for new frames: empty first, then the
        lowest-value unprotected keyframes, then (only if the batch exceeds
        window - protect_recent) the oldest protected ones."""
        empty = np.nonzero(self._order < 0)[0]
        if len(empty) >= n_needed:
            return empty[:n_needed]
        slots = list(empty)
        n_more = n_needed - len(empty)
        occupied_ix = np.nonzero(self._order >= 0)[0]
        recency = np.argsort(self._order[occupied_ix])[::-1]
        protected = set(occupied_ix[recency[: self.protect_recent]].tolist())
        value = self._frame_values()
        evictable = np.asarray(
            [s for s in occupied_ix if s not in protected], dtype=np.int64
        )
        if len(evictable):
            order = evictable[np.argsort(value[evictable])]
            slots.extend(order[:n_more].tolist())
            n_more = n_needed - len(slots)
        if n_more > 0:  # huge batch: give up the oldest protected frames
            by_age = occupied_ix[np.argsort(self._order[occupied_ix])]
            remaining = [s for s in by_age.tolist() if s not in slots]
            slots.extend(remaining[:n_more])
        return np.asarray(slots[:n_needed], dtype=np.int64)

    def update(self, batch_uvs):
        """Ingest (n_cameras, B, N, 2) detections (NaN = unseen); refine.

        Returns an info dict (cost, n_iters, window occupancy, admitted).
        """
        batch_uvs = np.asarray(batch_uvs, np.float64)
        C, B = batch_uvs.shape[:2]
        if C != self.n_cameras:
            raise ValueError(f"expected {self.n_cameras} cameras, got {C}")
        dev, dt = self.device, self._dtype

        # 1. pose init of the incoming frames at the current cameras, all
        # cameras at once, and their consensus, on the device (f64).
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        with record_function("rolling.pose_init"):
            batch_d = as_t(batch_uvs)
            per_cam = _batched_estimate_pose(
                batch_d,
                as_t(np.stack([K for K, _ in self._intr])),
                as_t(np.stack([d for _, d in self._intr])),
                as_t(self.objpoints),
            )
            poses_new = consensus_calib_poses(per_cam, as_t(self._ext))
            ok = ~np.isnan(poses_new.cpu().numpy()).any(-1)

        # 2. admit to the window (a batch larger than the window keeps its
        # newest `window` frames); the host mirrors carry only visibility
        # and arrival order (what eviction reads).
        with record_function("rolling.admit"):
            new_ix = np.nonzero(ok)[0]
            if len(new_ix) > self.window:
                new_ix = new_ix[-self.window:]
            slots = self._evict_slots(len(new_ix))
            for slot, j in zip(slots, new_ix):
                self._seen2d[:, slot] = ~np.isnan(batch_uvs[:, j]).any((-1, -2))
                self._order[slot] = self._next_arrival
                self._next_arrival += 1
            occupied = self._order >= 0
            active = occupied & ((self._seen2d & occupied[None]).sum(0) >= 2)

        # 3. scatter the admitted rows into the device window, then the
        # warm-started windowed LM on the active frames.
        nb = len(new_ix)
        with record_function("rolling.scatter"):
            if nb:
                sel = batch_d[:, torch.as_tensor(new_ix, device=dev)]
                slots_d = torch.as_tensor(slots, device=dev)
                self._obs_d[:, slots_d] = torch.nan_to_num(sel).to(dt)
                self._msk_d[:, slots_d] = ~torch.isnan(sel).any(-1)
                self._poses_d[slots_d] = torch.nan_to_num(
                    poses_new[torch.as_tensor(new_ix, device=dev)]).to(dt)
            mask_eff = self._msk_d & torch.as_tensor(active, device=dev)[None, :, None]
        lam = self._lam if self._lam is not None else float(self._opts.init_lambda)
        with record_function("rolling.lm_solve"):
            cam_d, self._poses_d, info = lm_solve(
                torch.as_tensor(_params_to_arrays(self._ext, self._intr), dtype=dt, device=dev),
                self._poses_d, self._obs_d, mask_eff, self._objp_d, self._opts,
                cam_free=self._cam_free, init_lam=lam,
            )
            # One read of the cameras; lm_solve's scalars are already host
            # floats.
            cam_h = cam_d.cpu().numpy().astype(np.float64)
        self._lam = float(info["lambda"])
        self._ext, self._intr = _arrays_to_params(cam_h)
        self.n_updates += 1
        return {
            "cost": float(info["final_cost"]),
            "n_iters": int(info["n_iters"]),
            "occupancy": self.occupancy,
            "admitted": int(nb),
        }
