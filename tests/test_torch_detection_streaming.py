"""Streamed batch detection (``detect_chessboard_batches``), CPU.

- The generator yields one dict per input batch, in order, ``{}`` for an
  empty batch, each bit-equal to a sequential ``detect_chessboard_batch``
  call on that batch with the same options, at full resolution and in the
  low band (f = 2). The stream changes no arithmetic.
- One batch of lookahead: batch k + 1 is dispatched before batch k is
  finished, and a dispatch reads nothing back.
- The JAX package's generator on the same batches: the same accepted
  frames, corners within 0.01 px.
- ``scale_factor != 1`` runs batch by batch through the per-frame path.
- The entry point defaults to the CUDA device and raises without one.

The streams and pinned buffers exist only on the card:
tests/test_torch_cuda.py holds the streamed run against sequential calls
there.
"""
import numpy as np
import pytest
import torch

from multicam_calibration_tpu.detection import detector as jdet
import multicam_calibration_tpu_torch as tmct
from multicam_calibration_tpu_torch.detection import detector as tdet
from tests.test_torch_detection_lowband import BOARD, _views


@pytest.fixture(scope="module")
def batches():
    frames = _views(5, 3100)
    return [frames[:2], [], frames[2:4], frames[4:]]


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])


@pytest.mark.parametrize("f", [1, 2])
def test_streamed_batches_equal_sequential_calls(batches, f):
    streamed = list(tmct.detect_chessboard_batches(
        iter(batches), board_shape=BOARD, coarse_downscale=f, device="cpu"))
    assert len(streamed) == len(batches) and streamed[1] == {}
    for got, images in zip(streamed, batches):
        want = tmct.detect_chessboard_batch(images, board_shape=BOARD, coarse_downscale=f,
                                            device="cpu")
        assert len(got) == len(images)  # clean views: every frame detected
        _assert_bit_equal(got, want)


def test_one_batch_of_lookahead(batches, monkeypatch):
    """The order of the halves over [2 frames, [], 2 frames, 1 frame]: a
    batch's dispatch comes before the previous batch's finish (an empty
    batch has nothing to dispatch), and no dispatch reads a tensor back."""
    events = []
    dispatch, finish = tdet._BatchOptions.dispatch, tdet._BatchOptions.finish

    def spy_dispatch(self, images, stage=None):
        events.append(("dispatch", len(images)))
        reads = ("item", "cpu", "tolist", "__bool__")
        real = {name: getattr(torch.Tensor, name) for name in reads}

        def refuse(*_a, **_k):
            raise AssertionError("dispatch read a tensor back")

        for name in reads:
            monkeypatch.setattr(torch.Tensor, name, refuse)
        try:
            return dispatch(self, images, stage)
        finally:
            for name in reads:
                monkeypatch.setattr(torch.Tensor, name, real[name])

    def spy_finish(self, state):
        events.append(("finish", state[1]))
        return finish(self, state)

    monkeypatch.setattr(tdet._BatchOptions, "dispatch", spy_dispatch)
    monkeypatch.setattr(tdet._BatchOptions, "finish", spy_finish)
    gen = tmct.detect_chessboard_batches(iter(batches), board_shape=BOARD, device="cpu")
    assert len(next(gen)) == 2 and events == [("dispatch", 2), ("finish", 2)]
    rest = list(gen)
    assert len(rest) == 3 and rest[0] == {}
    # Batch 3 (one frame) is dispatched before batch 2 is finished.
    assert events == [("dispatch", 2), ("finish", 2), ("dispatch", 2), ("dispatch", 1),
                      ("finish", 2), ("finish", 1)]


def test_streamed_batches_match_jax(batches):
    got = list(tmct.detect_chessboard_batches(batches, board_shape=BOARD, device="cpu"))
    ref = list(jdet.detect_chessboard_batches(batches, board_shape=BOARD))
    assert len(got) == len(ref) == len(batches)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for i in r:
            np.testing.assert_allclose(g[i][0], np.asarray(r[i][0], float), atol=0.01)


def test_scale_factor_runs_batch_by_batch(batches, monkeypatch):
    calls = []
    monkeypatch.setattr(tdet, "detect_chessboard",
                        lambda img, **kw: calls.append(kw["scale_factor"]))
    out = list(tmct.detect_chessboard_batches(batches, board_shape=BOARD, scale_factor=0.5,
                                              device="cpu"))
    assert out == [{}] * len(batches) and calls == [0.5] * 5


def test_entry_point_needs_a_card_unless_told(batches, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tmct.detect_chessboard_batches(batches, board_shape=BOARD))
    with pytest.raises(TypeError, match="flags"):
        next(tmct.detect_chessboard_batches(batches, board_shape=BOARD, flags=3, device="cpu"))
    assert list(tmct.detect_chessboard_batches([], board_shape=BOARD, device="cpu")) == []
