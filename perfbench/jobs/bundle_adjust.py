"""Refinement traffic: ``bundle_adjust`` on one rig's detections from a
start near the truth, one call after another.

The rig is the frozen ``make_synthetic_rig`` at the configuration's sizes,
made from the run's seed. The start keeps the true intrinsics and board
poses and adds N(0, ``start_sd``) to every extrinsic parameter (the mix
file's ``start_sd``). Every call runs with the configuration's options on
the same input.
"""
from __future__ import annotations

import numpy as np

from ..frozen import synthetic
from ..harness.core import sub_seed
from ..reference import ba as reference


class Job:
    cycle = 1  # jobs that make a whole cycle of the inputs
    kind = "bundle_adjust"

    def __init__(self, config, mix, seed, device, seconds):
        import torch

        self.device = torch.device(device)
        self.config = config
        self.seed = seed
        rig = synthetic.make_synthetic_rig(
            n_cameras=config["n_cameras"], n_frames=config["n_frames"],
            board_shape=tuple(config["board_shape"]), square_size=config["square_mm"],
            noise_px=config["noise_px"], dropout=config["dropout"],
            img_size=tuple(config["img_size"]), seed=sub_seed(seed, 1))
        ext = rig.all_extrinsics + np.random.default_rng(sub_seed(seed, 2)).normal(
            0, float(mix["start_sd"]), rig.all_extrinsics.shape)
        self.rig = rig
        self.start = (ext, rig.all_intrinsics, rig.calib_poses)
        self.results = []
        self.spans = {}

    def _adjust(self):
        import multicam_calibration_tpu_torch as program
        from torch.profiler import record_function

        with record_function("perfbench.bundle_adjust"):
            return program.bundle_adjust(self.rig.all_calib_uvs, *self.start[:2],
                                         self.rig.calib_objpoints, self.start[2], verbose=False,
                                         device=self.device, **self.config["bundle_adjust"])

    def warm(self):
        self._adjust()

    def step(self):
        self.results.append(self._adjust())
        return 1

    def close(self):
        pass

    def end_to_end(self, record, window_s):
        return {"ba_s": window_s / len(record)}

    def shapes(self):
        """The solved problem's (C, F, N, observed points) of the last call."""
        uvs = self.rig.all_calib_uvs
        frames = self.results[-1][3]
        n_obs = int((~np.isnan(uvs[:, frames]).any(-1)).sum())
        return {"ba_problem": (uvs.shape[0], len(frames), uvs.shape[2], n_obs)}

    def check(self, limits):
        """Judge one call of the window, drawn from the seed."""
        pick = np.random.default_rng(sub_seed(self.seed, 4)).integers(len(self.results))
        ext, intr, poses, frames, info = self.results[pick]
        numbers = reference.judge(
            self.rig.all_calib_uvs, self.start, (ext, intr, poses, frames, info["final_cost"]),
            self.rig.calib_objpoints, self.config["bundle_adjust"].get("n_frames", 10000),
            int(self.config["reference"]["polish_iters"]), self.device)
        return {k: (v, limits[k]) for k, v in numbers.items()}
