"""The low-band path on hard frames and its escalation: PyTorch port vs JAX, CPU.

- The hard frames and the noise frame of
  tests/test_detection_lowband.py::TestLowbandEscalation through both
  packages' ``detect_chessboard_batch(..., coarse_downscale=2)``: the noise
  frame stays undetected, the frames the low-res pass loses escalate to the
  full-resolution path (in the port unpadded, in the JAX package padded to
  a power of two), and the port makes JAX's decisions: the same accepted
  frames, corners within 0.01 px, sorted anchor scores within 1e-3.
- The escalation without the padding: a batch and the same batch with a
  repeated frame decide each frame the same way.
"""
import numpy as np

from multicam_calibration_tpu.detection import detector as jdet
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import detector as tdet
from tests.test_torch_detection_lowband import BOARD, HARD_KW, _assert_same_detections, _views


def test_lowband_noise_and_hard_frames_match_jax(monkeypatch):
    """TestLowbandEscalation's frames: the noise frame stays undetected, and
    the hard frames the low-res pass loses escalate to the full-resolution
    path, unpadded, deciding as JAX's padded escalation."""
    frames = _views(2, 3200, **HARD_KW)
    frames.append(np.random.default_rng(5).integers(0, 256, frames[0].shape, dtype=np.uint8))
    escalated = []
    finish = tdet._BatchOptions.finish

    def spy(self, state):
        if not self.lowband:
            escalated.append(state[1])
        return finish(self, state)

    monkeypatch.setattr(tdet._BatchOptions, "finish", spy)
    got = tmct.detect_chessboard_batch(frames, board_shape=BOARD, coarse_downscale=2,
                                       device="cpu")
    ref = jdet.detect_chessboard_batch(frames, board_shape=BOARD, coarse_downscale=2)
    assert 2 not in got
    assert escalated and escalated[0] >= 1  # the noise frame at least; not a power of two
    _assert_same_detections(got, ref, "hard")


def test_escalation_decides_without_padding():
    """The JAX package pads the escalated frames to a power of two with
    repeats of the first; the port runs them alone. Each frame decides the
    same either way, its corners and scores equal to f32 rounding (1e-5:
    the batched products round differently at another batch size)."""
    frames = _views(3, 3200, **HARD_KW)
    alone = tmct.detect_chessboard_batch(frames, board_shape=BOARD, device="cpu")
    padded = tmct.detect_chessboard_batch(frames + [frames[0]], board_shape=BOARD, device="cpu")
    assert sorted(padded) == sorted(alone) + [3] * (0 in alone)
    for i in alone:
        np.testing.assert_allclose(alone[i][0], padded[i][0], atol=1e-5)
        np.testing.assert_allclose(alone[i][1], padded[i][1], atol=1e-5)
