"""Calibration traffic: ``calibrate`` on one session's detections, then
``bundle_adjust`` from its result, one pipeline after another.

The session is the frozen ``make_synthetic_rig`` at the configuration's
sizes, made from the run's seed: its detections are the only input, so
the intrinsics, the board poses, the spanning tree and the consensus all
come from the program, and the refinement starts where ``calibrate``
left it. Both entry points run with the configuration's option dicts.
"""
from __future__ import annotations

import numpy as np

from ..frozen import synthetic
from ..harness.core import sub_seed
from ..reference import ba as reference
from ..reference.rolling import rotation_error


class Job:
    cycle = 1  # jobs that make a whole cycle of the inputs
    kind = "calibrate"

    def __init__(self, config, mix, seed, device, seconds):
        import torch

        self.device = torch.device(device)
        self.config = config
        self.seed = seed
        self.rig = synthetic.make_synthetic_rig(
            n_cameras=config["n_cameras"], n_frames=config["n_frames"],
            board_shape=tuple(config["board_shape"]), square_size=config["square_mm"],
            noise_px=config["noise_px"], dropout=config["dropout"],
            img_size=tuple(config["img_size"]), seed=sub_seed(seed, 1))
        self.results = []
        self.spans = {}

    def _pipeline(self):
        import multicam_calibration_tpu_torch as program
        from torch.profiler import record_function

        rig = self.rig
        with record_function("perfbench.calibrate"):
            ext, intr, poses, _ = program.calibrate(
                rig.all_calib_uvs, rig.img_sizes, rig.calib_objpoints, verbose=False,
                device=self.device, **self.config["calibrate"])
        with record_function("perfbench.bundle_adjust"):
            out = program.bundle_adjust(rig.all_calib_uvs, ext, intr, rig.calib_objpoints,
                                        poses, verbose=False, device=self.device,
                                        **self.config["bundle_adjust"])
        return (ext, intr, poses), out

    def warm(self):
        self._pipeline()

    def step(self):
        self.results.append(self._pipeline())
        return 1

    def close(self):
        pass

    def end_to_end(self, record, window_s):
        return {"ba_s": window_s / len(record)}

    def shapes(self):
        """The refined problem's (C, F, N, observed points) of the last pipeline."""
        uvs = self.rig.all_calib_uvs
        frames = self.results[-1][1][3]
        n_obs = int((~np.isnan(uvs[:, frames]).any(-1)).sum())
        return {"ba_problem": (uvs.shape[0], len(frames), uvs.shape[2], n_obs)}

    def check(self, limits):
        """Judge one pipeline of the window, drawn from the seed: its
        refinement against the float64 reference from its own ``calibrate``
        start, and its cameras against the truth."""
        pick = np.random.default_rng(sub_seed(self.seed, 4)).integers(len(self.results))
        start, (ext, intr, poses, frames, info) = self.results[pick]
        numbers = reference.judge(
            self.rig.all_calib_uvs, start, (ext, intr, poses, frames, info["final_cost"]),
            self.rig.calib_objpoints, self.config["bundle_adjust"].get("n_frames", 10000),
            int(self.config["reference"]["polish_iters"]), self.device)
        # Rotation vectors alone: ``rotation`` takes the norm of what it is
        # given as the angle, so a whole 6-vector would fold the translation in.
        numbers["rot_err_rad"] = rotation_error(np.asarray(ext)[:, :3],
                                                self.rig.all_extrinsics[:, :3])
        return {k: (v, limits[k]) for k, v in numbers.items()}
