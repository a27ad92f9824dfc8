"""Detection traffic: batches of one camera's frames, in session order,
through ``detect_chessboard_batches`` (``_detect_video``'s call).

The mix file gives the batch size, how many frames of each batch show a
detectable board (the rest show none), the length of the board trajectory the views are
drawn from, and the frame rate above which the bank is cycled with fresh
grey-level noise. The bank is rendered at set-up from the run's seed by the
frozen generator, one worker process per camera, ``frames_per_camera``
(the configuration's) a camera; the mix of every batch
is fixed, so the seed moves the views and not the work's make-up.
"""
from __future__ import annotations

import concurrent.futures
import math
import multiprocessing
import os

import numpy as np

from ..frozen import render, synthetic
from ..harness.core import sub_seed
from ..reference import detect as reference

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _in_processes(fn, args):
    """``[fn(*a) for a in args]`` in spawned workers, one per item up to the
    host's cores, each with one BLAS / OpenMP thread; every worker has ended
    when this returns."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    try:
        with concurrent.futures.ProcessPoolExecutor(
                min(len(args), os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(fn, *zip(*args)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def synthetic_camera(rig, c):
    """Camera ``c`` of ``rig`` alone, with the whole board trajectory."""
    return synthetic.SyntheticRig(rig.all_extrinsics[c:c + 1], rig.all_intrinsics[c:c + 1],
                                  rig.calib_poses, rig.calib_objpoints,
                                  rig.all_calib_uvs[c:c + 1], rig.img_sizes[c:c + 1])


MAX_STRETCHES = 20


def more_views(cam, T0, excursion_mm, dropout, key):
    """Camera ``cam`` with a further stretch of board trajectory, as long as
    its first, drawn from ``key``: for a camera that the session's
    trajectory shows too few detectable views."""
    rng = np.random.default_rng(sub_seed(*key))
    objp, n = cam.calib_objpoints, len(cam.calib_poses)
    poses = synthetic.make_board_trajectory(n, rng=rng, scale=excursion_mm)
    poses[:, 3:] -= objp.mean(0)
    poses = np.stack([render.t6(T0 @ synthetic._t6_to_T(p)) for p in poses])
    uvs = np.zeros((1, n, len(objp), 2))
    uvs[0, rng.uniform(size=n) <= dropout] = np.nan  # dropped: rendered board-less
    return synthetic.SyntheticRig(cam.all_extrinsics, cam.all_intrinsics, poses, objp, uvs,
                                  cam.img_sizes)


def camera_bank(cam, T0, board_shape, video, dropout, B, nb, per_cam, seed_keys):
    """One camera's bank (a worker process's job): its views classified in
    trajectory order until ``per_cam`` batches can be filled, each with the
    next ``nb`` detectable views and the next ``B - nb`` board-less ones in
    order (with further stretches of trajectory where the first shows too
    few), then rendered. Returns (frames, truth, shows a board)."""
    need = np.array([nb * per_cam, (B - nb) * per_cam])
    shown, det, Hs = [], [], []
    for k in range(MAX_STRETCHES):
        views = cam if k == 0 else more_views(cam, T0, video["excursion_mm"], dropout,
                                              (*seed_keys, 7, k))
        have = np.array([sum(d.sum() for d in det), sum((~s).sum() for s in shown)])
        s, d, H = render.classify_views(
            views, 0, board_shape, video["margin_px"], video["pitch_px"], video["tilt_deg"],
            need=tuple(np.maximum(need - have, 0)))
        shown.append(s)
        det.append(d)
        Hs.append(H)
        if (have + [d.sum(), (~s).sum()] >= need).all():
            break
    shown, det, Hs = np.concatenate(shown), np.concatenate(det), np.concatenate(Hs)
    with_board, without = np.nonzero(det)[0], np.nonzero(~shown)[0]
    if len(with_board) < need[0] or len(without) < need[1]:
        raise ValueError(f"camera {seed_keys[2]}: {len(with_board)} detectable and "
                         f"{len(without)} board-less views in {MAX_STRETCHES} stretches")
    picks = []
    for b in range(per_cam):
        picks += sorted([*with_board[b * nb:(b + 1) * nb],
                         *without[b * (B - nb):(b + 1) * (B - nb)]])
    picks = np.asarray(picks)
    K, dist = cam.all_intrinsics[0]
    seeds = [sub_seed(*seed_keys, int(f)) for f in picks]
    frames, truth = render.render_views(K, dist, cam.img_sizes[0], Hs[picks], board_shape,
                                        video["render_noise"], video["blur_sigma"], seeds)
    return frames, truth, det[picks]


class Job:
    cycle = 1  # jobs that make a whole cycle of the inputs
    kind = "detect"

    def __init__(self, config, mix, seed, device, seconds):
        import torch

        self.device = torch.device(device)
        video = config["video"]
        self.board_shape = tuple(config["board_shape"])
        self.wrong_px = config["guarantees"]["wrong_px"]
        B, nb = int(mix["batch"]), int(mix["board_per_batch"])
        per_cam = int(config["frames_per_camera"]) // B
        rig, T0 = render.video_rig(
            n_cameras=config["n_cameras"], n_frames=int(mix["trajectory_frames"]),
            radius_mm=video["radius_mm"], excursion_mm=video["excursion_mm"],
            img_size=tuple(video["img_size"]), noise_px=config["noise_px"],
            dropout=config["dropout"], board_shape=self.board_shape,
            square_mm=config["square_mm"], seed=sub_seed(seed, 1))
        args = [(synthetic_camera(rig, c), T0, self.board_shape, video, config["dropout"], B,
                 nb, per_cam, [seed, 2, c]) for c in range(rig.n_cameras)]
        out = _in_processes(camera_bank, args)
        self.frames = np.stack([f for f, _, _ in out])  # (C, per_cam * B, h, w) uint8
        self.truth = np.stack([t for _, t, _ in out])
        self.board = np.stack([b for _, _, b in out])
        self.hw = self.frames.shape[2:]
        C = rig.n_cameras
        self.order = [(c, b) for c in range(C) for b in range(per_cam)]
        self.B = B
        # Copies of the bank with fresh +-2 grey-level noise, for a window
        # that would outrun it at ``max_fps``.
        n_bank = self.frames[:, :, 0, 0].size
        copies = max(0, math.ceil(seconds * float(mix["max_fps"]) / n_bank) - 1)
        rng = np.random.default_rng(sub_seed(seed, 3))
        self.banks = [self.frames] + [
            np.clip(self.frames.astype(np.int16)
                    + rng.integers(-2, 3, self.frames.shape, dtype=np.int16), 0, 255)
            .astype(np.uint8) for _ in range(copies)]
        self.fed, self.done = [], []
        self.spans = {}
        self._gen = None

    def _detect(self, batches):
        from multicam_calibration_tpu_torch import detect_chessboard_batches

        return detect_chessboard_batches(batches, board_shape=self.board_shape,
                                         device=self.device)

    def _window_batches(self):
        k = 0
        while True:
            bank = self.banks[(k // len(self.order)) % len(self.banks)]
            c, b = self.order[k % len(self.order)]
            self.fed.append((c, b))
            yield bank[c, b * self.B:(b + 1) * self.B]
            k += 1

    def warm(self):
        """One batch of camera 0's frames: every board view of its bank and
        board-less views to fill the batch, so stage 1, the host finish and
        the coarse ladder all run once at the window's shapes."""
        boards = np.nonzero(self.board[0])[0]
        rest = np.nonzero(~self.board[0])[0][: self.B - len(boards)]
        batch = self.frames[0, np.sort(np.concatenate([boards, rest]))[: self.B]]
        for _ in self._detect([batch]):
            pass
        self._gen = self._detect(self._window_batches())

    def step(self):
        self.done.append(next(self._gen))
        return self.B

    def close(self):
        self._gen.close()
        self.banks = self.frames = None

    def end_to_end(self, record, window_s):
        return {"detect_fps": sum(u for _, _, u in record) / window_s}

    def shapes(self):
        return {"frame_hw": self.hw, "nms_radius": 4}

    def check(self, limits):
        found, truth, board = [], [], []
        for (c, b), out in zip(self.fed, self.done):
            sl = slice(b * self.B, (b + 1) * self.B)
            for i in range(self.B):
                found.append(out[i][0] if i in out else None)
            truth.append(self.truth[c, sl])
            board.append(self.board[c, sl])
        numbers = reference.judge(found, np.concatenate(truth), np.concatenate(board),
                                  self.wrong_px)
        return {k: (v, limits[k]) for k, v in numbers.items()}
