"""The controls of ``correct``: the reference or the program, in the
nearest precision below the configuration's, put in the program's place.

- Detection: the renderer's float64 corners rounded to bfloat16 (the
  detector computes in float32), answered for every board frame and for
  no other.
- Refinement: the program's own float32 path,
  ``bundle_adjust(..., dtype="float32")`` (the configuration states float64
  results).
- Rolling re-calibration: the program's own float32 path,
  ``RollingCalibrator(..., dtype="float32")``.

``python -m perfbench.tests.controls <cell> <seed>...`` runs a cell's
control at its own size on the card and prints each run's numbers beside
its limits, one JSON line a seed.
"""
import json
import sys
from unittest import mock

from perfbench.harness import core, spec
from perfbench.jobs import detect


def bf16_detections(self, batches):
    """Per batch, after a pause that keeps a short window to a few batches,
    as a run compares."""
    import time

    import torch

    for _ in batches:
        time.sleep(0.3)
        if not self.fed:  # the warm-up batch
            yield {}
            continue
        c, b = self.fed[-1]
        sl = slice(b * self.B, (b + 1) * self.B)
        truth, board = self.truth[c, sl], self.board[c, sl]
        yield {i: (torch.as_tensor(truth[i]).to(torch.bfloat16).double().numpy(), None)
               for i in range(self.B) if board[i]}


# Windows that judge about as many answers as a run of the cell does.
SECONDS = {"rig6.detect_mixed": 0.8, "stage64.rolling": 3.0, "stage64.ba": 1.0}


def control(cell, seed, device, seconds=None, overrides=None):
    """One run of ``cell``'s control; returns the run's result dict."""
    over = {k: dict(v) for k, v in (overrides or {}).items()}
    seconds = SECONDS[cell] if seconds is None else seconds
    if cell.startswith("rig6.detect"):
        with mock.patch.object(detect.Job, "_detect", bf16_detections):
            return core.run_cell(cell, seed, seconds, 0, device, overrides=over)
    cfg = over.setdefault("config", {})
    key = "rolling" if cell.endswith(".rolling") else "bundle_adjust"
    cfg[key] = {**spec.load_cell(cell).config[key], **cfg.get(key, {}), "dtype": "float32"}
    return core.run_cell(cell, seed, seconds, 0, device, overrides=over)


if __name__ == "__main__":
    import torch

    for s in sys.argv[2:]:
        r = control(sys.argv[1], int(s), torch.device("cuda", 0))
        print(json.dumps({"cell": sys.argv[1], "seed": int(s), "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
