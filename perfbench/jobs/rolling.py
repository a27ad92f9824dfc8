"""Rolling traffic: ``RollingCalibrator.update`` on batches of one rig's
frames, one update after another, from mount-drifted cameras.

The rig is the frozen ``make_synthetic_rig`` at the configuration's sizes,
made from the run's seed; the calibrator starts from the frozen
``stream_start`` drift of its cameras with the configuration's
``rolling`` options. The mix file gives the batch size, the updates that
fill the keyframe window at set-up, the update rate whose frames a window
may consume before the frames are fed again from the first, and how many
updates besides the last are judged. Each update's time runs from the
batch's detections on the host to the refined cameras on the host.
"""
from __future__ import annotations

import math

import numpy as np

from ..frozen import drift, synthetic
from ..harness.core import sub_seed
from ..reference import rolling as reference


class Job:
    cycle = 1  # jobs that make a whole cycle of the inputs
    kind = "rolling"

    def __init__(self, config, mix, seed, device, seconds):
        import torch

        self.device = torch.device(device)
        self.config, self.mix, self.seed = config, mix, seed
        self.B = int(mix["batch"])
        self.fill = int(mix["fill_updates"])
        n_batches = self.fill + math.ceil(seconds * float(mix["max_updates_per_s"])) + 1
        self.rig = synthetic.make_synthetic_rig(
            n_cameras=config["n_cameras"], n_frames=self.B * n_batches,
            board_shape=tuple(config["board_shape"]), square_size=config["square_mm"],
            noise_px=config["noise_px"], dropout=config["dropout"],
            img_size=tuple(config["img_size"]), seed=sub_seed(seed, 1))
        self.start = drift.stream_start(self.rig, sub_seed(seed, 2))
        self.n_batches = n_batches
        self.fed, self.infos, self.cams = [], [], []
        self.spans = {}
        self.rc = None

    def _update(self):
        k = len(self.fed) % self.n_batches
        frames = np.arange(k * self.B, (k + 1) * self.B)
        info = self.rc.update(self.rig.all_calib_uvs[:, frames])
        self.fed.append(frames)
        self.infos.append(info)
        return info

    def warm(self):
        """The calibrator, and the updates that fill its window: from here
        on every update evicts."""
        import multicam_calibration_tpu_torch as program

        self.rc = program.RollingCalibrator(*self.start, self.rig.calib_objpoints,
                                            device=self.device, **self.config["rolling"])
        for _ in range(self.fill):
            self._update()
        self.n_warm = len(self.fed)

    def step(self):
        self._update()
        self.cams.append(self.rc.calibration()[0])
        return 1

    def close(self):
        self.rc = None

    def end_to_end(self, record, window_s):
        return {"update_p90_ms": float(np.percentile([1e3 * (b - a) for a, b, _ in record], 90))}

    def shapes(self):
        return {}

    def check(self, limits):
        """Replay every update's window; judge the last update of the
        window and ``judged_updates`` more drawn from the seed."""
        timed = len(self.cams)
        rng = np.random.default_rng(sub_seed(self.seed, 4))
        picks = {timed - 1, *rng.choice(timed, min(timed, int(self.mix["judged_updates"])),
                                        replace=False).tolist()}
        judged = {self.n_warm + t: (self.cams[t], self.infos[self.n_warm + t]["cost"])
                  for t in picks}
        opts = self.config["rolling"]
        numbers = reference.judge(
            self.rig.all_calib_uvs, self.fed, [i["admitted"] for i in self.infos], judged,
            self.start[1], self.rig.calib_objpoints, self.rig.all_extrinsics,
            self.rig.calib_poses, opts["window"], opts["protect_recent"], self.device)
        return {k: (v, limits[k]) for k, v in numbers.items()}
