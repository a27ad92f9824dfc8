"""Plain reference for rolling re-calibration: which frames an update's
keyframe window holds, and the float64 soft-L1 cost, reprojection RMSE
and camera error of that window at the cameras the update returned, with
every window frame's board pose solved by the reference itself.

Written from the documented semantics of the rolling calibrator (the JAX
package's and the port's ``models/streaming.py`` docstrings): a frame is
admitted when some camera sees it whole; it takes an empty slot first,
then the slot of the unprotected keyframe of least value, then that of
the oldest protected one; the ``protect_recent`` newest keyframes are
protected; a keyframe's value is the sum, over the camera pairs that both
see it, of 1 / the keyframes that pair sees; a keyframe seen by two
cameras or more takes part in the solve, whose cost is the soft-L1 cost
(``f_scale`` 1) of its observations. Imports nothing of the program.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .ba import F64, Problem, camera_params, rotation


class Window:
    """A replay of the keyframe window over the batches fed to it."""

    def __init__(self, n_cameras, window, protect_recent):
        self.order = np.full(window, -1, np.int64)  # arrival index per slot
        self.seen = np.zeros((n_cameras, window), bool)
        self.frame = np.full(window, -1, np.int64)  # the rig's frame per slot
        self.arrivals = 0
        self.protect = int(protect_recent)

    def values(self):
        so = self.seen & (self.order >= 0)[None]
        a, b = np.triu_indices(so.shape[0], k=1)
        co = so[a] & so[b]  # (pairs, slots)
        counts = co.sum(1)
        nz = counts > 0
        if not nz.any():
            return np.zeros(len(self.order))
        return (co[nz] / counts[nz, None]).sum(0)

    def slots(self, n):
        empty = np.nonzero(self.order < 0)[0]
        if len(empty) >= n:
            return empty[:n]
        occupied = np.nonzero(self.order >= 0)[0]
        newest = occupied[np.argsort(self.order[occupied])[::-1][:self.protect]]
        free = np.setdiff1d(occupied, newest)
        take = list(empty) + list(free[np.argsort(self.values()[free])][:n - len(empty)])
        if len(take) < n:  # a batch larger than the unprotected keyframes
            by_age = occupied[np.argsort(self.order[occupied])]
            take += [s for s in by_age if s not in take][:n - len(take)]
        return np.asarray(take[:n], np.int64)

    def admit(self, seen, frames):
        """Feed one batch: ``seen`` (C, B) cameras that see each frame whole,
        ``frames`` (B,) its frames' indices. Returns the frames admitted."""
        new = np.nonzero(seen.any(0))[0][-len(self.order):]
        for slot, j in zip(self.slots(len(new)), new):
            self.seen[:, slot] = seen[:, j]
            self.order[slot] = self.arrivals
            self.frame[slot] = frames[j]
            self.arrivals += 1
        return len(new)

    def solved_frames(self):
        """The rig's frames that take part in the window's solve."""
        occupied = self.order >= 0
        return np.sort(self.frame[occupied & ((self.seen & occupied[None]).sum(0) >= 2)])


def solve_poses(prob, cam, pose, iters=12):
    """Board poses that minimise ``prob``'s cost at the fixed cameras
    ``cam``, from ``pose``: damped Gauss-Newton, each frame's 6 x 6 system
    on its own. Returns (poses, cost)."""
    eye = torch.eye(6, dtype=F64, device=cam.device)
    best, lam = prob.cost(cam, pose), 1e-8
    for _ in range(iters):
        _, V, _, _, gp = prob.normal_blocks(cam, pose)
        for _try in range(6):
            Vd = V + lam * torch.diag_embed(torch.diagonal(V, dim1=-2, dim2=-1)) + 1e-12 * eye
            step = -torch.linalg.solve(Vd, gp[..., None])[..., 0]
            new = prob.cost(cam, pose + step)
            if new <= best:
                break
            lam *= 10.0
        else:
            break
        pose, done = pose + step, best - new <= 1e-15 * best
        best, lam = new, max(lam / 10.0, 1e-12)
        if done:
            break
    return pose, best


def rotation_error(ext, truth):
    """Largest angle (rad) between a camera's rotation relative to camera 0
    in ``ext`` and in ``truth`` (6-vector extrinsics, world -> camera)."""
    R = rotation(torch.as_tensor(np.asarray(ext, float), dtype=F64))
    T = rotation(torch.as_tensor(np.asarray(truth, float), dtype=F64))
    D = (R @ R[0].mT) @ (T @ T[0].mT).mT
    skew = D - D.mT
    s = torch.linalg.vector_norm(torch.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], -1),
                                 dim=-1) / 2
    c = (torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2
    return float(torch.atan2(s, c).max())


def judge(uvs, fed, admitted, judged, intrinsics, objp, truth_ext, truth_poses, window,
          protect_recent, device):
    """The numbers by which a stream of updates is judged.

    ``uvs`` (C, F, N, 2) the rig's detections (NaN: unseen); ``fed`` the
    frame indices of every update's batch, in order; ``admitted`` the count
    each update reported; ``judged`` {update: (extrinsics it returned, cost
    it returned)}. ``admitted_off``: admitted frames that differ from the
    replay, over every update. For each judged update, at its cameras and
    window: ``cost_gap``, the reported cost's distance from the float64
    cost at the best poses, relative to it; ``rmse_px``, the window's
    reprojection RMSE there; ``rot_err_rad``, the cameras' rotation error
    against the truth. Each is the worst over the judged updates."""
    uvs = np.asarray(uvs, float)
    seen = ~np.isnan(uvs).any((-1, -2))  # (C, F)
    win = Window(uvs.shape[0], window, protect_recent)
    numbers = {"admitted_off": 0.0, "cost_gap": 0.0, "rmse_px": 0.0, "rot_err_rad": 0.0}
    for u, frames in enumerate(fed):
        numbers["admitted_off"] += abs(win.admit(seen[:, frames], frames) - admitted[u])
        if u not in judged:
            continue
        ext, reported = judged[u]
        use = win.solved_frames()
        prob = Problem(uvs[:, use], objp, device)
        cam = torch.as_tensor(camera_params(ext, intrinsics), dtype=F64, device=device)
        start = torch.as_tensor(np.asarray(truth_poses, float)[use], dtype=F64, device=device)
        pose, cost = solve_poses(prob, cam, start)
        each = {"cost_gap": abs(float(reported) - cost) / cost, "rmse_px": prob.rmse(cam, pose),
                "rot_err_rad": rotation_error(ext, truth_ext)}
        print(f"perfbench: update {u} ({len(use)} frames): "
              + ", ".join(f"{k} {v!r}" for k, v in each.items()), file=sys.stderr)
        for k, v in each.items():
            numbers[k] = max(numbers[k], v)
    return numbers
