"""Video decode and video-level detection: the port vs the JAX package.

The rig is this file's copy of tests/test_cli_config.py's: two cameras x 14
frames of a 5x7 board rendered by homography, written as mp4 (OpenCV's
mp4v) and read back by each package's reader. Both packages detect on the
CPU (the port through its plain kernel twins).

- ``process_video``: the port's ``.detections.h5`` has the JAX package's
  datasets with the same dtypes and shapes; ``frame_ixs`` and
  ``img_size`` equal, ``uvs`` within 0.01 px and ``qc_data`` (the anchor
  scores) within 1e-3, the detection parity tolerances of
  tests/test_torch_detection.py.
- ``run_calibration_detection`` with NaN in ``aligned_frame_ixs``: the
  NaN-padded array equals JAX's NaN for NaN and within 0.01 px (including
  where JAX's ``np.searchsorted`` mapping misplaces rows), the image sizes
  equal; ``summarize_detections`` equals JAX's DataFrame.
- The per-frame path (``batch_size=0``) and the batched path with a padded
  tail give the same detections (corners within 1e-9 px, the f32 scores
  within 1e-6); a KeyboardInterrupt saves what was found;
  a video without a board raises ``ValueError("No detections found")``;
  without ``h5py`` both public functions raise ImportError naming it.
- Where the native runtime builds here, the port's ``NativeVideoReader``
  decodes the frames the JAX package's does, bit for bit; ``open_video``
  names its backend.
"""
import builtins
import os
import shutil

import h5py
import numpy as np
import pytest

import multicam_calibration_tpu as jmct
from multicam_calibration_tpu.detection import video as jvideo
from multicam_calibration_tpu_torch.detection import native_video as tnv
from multicam_calibration_tpu_torch.detection import video as tvideo

BOARD = (5, 7)
SQUARE = 12.5
OPTIONS = {"board_shape": BOARD}
UV_ATOL, SCORE_ATOL = 0.01, 1e-3


def render_camera_video(path, K, ext_cam, board_poses, img_size, square_px=40, margin=2,
                        fourcc="mp4v"):
    """Write a video of homography-rendered board views for one camera
    (tests/test_cli_config.py's renderer); returns the true corners."""
    import cv2

    from multicam_calibration_tpu_torch.detection.synthetic_images import render_board_image
    from multicam_calibration_tpu_torch.synthetic import _project_np, _t6_to_T

    canonical, can_corners = render_board_image(BOARD, square_px, margin)
    objpoints = jmct.generate_chessboard_objpoints(BOARD, SQUARE)
    w, h = img_size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 30, (w, h), isColor=False)
    assert writer.isOpened()
    gts = []
    for pose in board_poses:
        T = _t6_to_T(pose)
        world = objpoints @ T[:3, :3].T + T[:3, 3]
        uv = _project_np(world, ext_cam, K, np.zeros(5))
        H, _ = cv2.findHomography(can_corners, uv)
        view = cv2.warpPerspective(canonical, H, (w, h), flags=cv2.INTER_LINEAR,
                                   borderValue=170.0)
        view = cv2.GaussianBlur(view, (0, 0), 1.0)
        writer.write(view.astype(np.uint8))
        gts.append(uv)
    writer.release()
    return np.stack(gts)


def make_video_rig(directory):
    """Two cameras x 14 frames (tests/test_cli_config.py:83-127)."""
    img_size = (640, 480)
    K = np.array([[900.0, 0, 320], [0, 900.0, 240], [0, 0, 1]])
    ext0 = np.zeros(6)
    ext1 = np.concatenate([[0.0, 0.35, 0.0], [-160.0, 0.0, 40.0]])
    poses = []
    for k in range(14):
        rot = np.array([0.35 * np.sin(k), 0.35 * np.cos(1.3 * k), 0.2 * np.sin(2.1 * k)])
        trans = np.array([-50 + 12 * np.sin(0.9 * k), -40 + 12 * np.cos(1.7 * k),
                          450 + 40 * np.sin(0.5 * k)])
        poses.append(np.concatenate([rot, trans]))
    poses = np.stack(poses)
    paths, gts = [], []
    for name, ext in [("camA", ext0), ("camB", ext1)]:
        p = os.path.join(directory, f"{name}.mp4")
        gts.append(render_camera_video(p, K, ext, poses, img_size))
        paths.append(p)
    return {"paths": paths, "gts": gts, "K": K, "extrinsics": np.stack([ext0, ext1]),
            "poses": poses}


@pytest.fixture(scope="module")
def video_rig(tmp_path_factory):
    return make_video_rig(str(tmp_path_factory.mktemp("videos")))


def _copies(video_rig, directory):
    """The rig's videos copied into ``directory`` (each package writes its
    cache beside the video)."""
    os.makedirs(directory, exist_ok=True)
    out = []
    for p in video_rig["paths"]:
        q = os.path.join(directory, os.path.basename(p))
        shutil.copy(p, q)
        out.append(q)
    return out


def _read_cache(path):
    with h5py.File(path, "r") as h5:
        return {k: h5[k][()] for k in h5}


@pytest.fixture(scope="module")
def caches(video_rig, tmp_path_factory):
    """{package: [cache dict per camera]} of process_video on both videos."""
    out = {}
    for who, fn, kw in (("jax", jvideo.process_video, {}),
                        ("torch", tvideo.process_video, {"device": "cpu"})):
        paths = _copies(video_rig, str(tmp_path_factory.mktemp(who)))
        out[who] = [_read_cache(fn(p, detection_options=OPTIONS, **kw)) for p in paths]
    return out


def test_process_video_cache_matches_jax(caches, video_rig):
    for cam, (got, ref) in enumerate(zip(caches["torch"], caches["jax"])):
        assert sorted(got) == sorted(ref) == ["frame_ixs", "img_size", "qc_data", "uvs"]
        for key in ref:
            assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got["frame_ixs"], ref["frame_ixs"])
        np.testing.assert_array_equal(got["img_size"], ref["img_size"])
        np.testing.assert_allclose(got["uvs"], ref["uvs"], rtol=0, atol=UV_ATOL)
        np.testing.assert_allclose(got["qc_data"], ref["qc_data"], rtol=0, atol=SCORE_ATOL)
        assert len(got["frame_ixs"]) >= 12  # the rig's views are all detectable
        gt = video_rig["gts"][cam][got["frame_ixs"]]
        assert np.sqrt(((got["uvs"] - gt) ** 2).sum(-1).mean()) < 0.6


def test_run_calibration_detection_with_nan_alignment_matches_jax(video_rig, tmp_path):
    aligned = np.stack([np.arange(14.0), np.arange(14.0)], 1)
    aligned[3, 0] = np.nan  # camera A missed frame 3
    aligned[[7, 8], 1] = np.nan  # camera B missed frames 7 and 8
    got = tvideo.run_calibration_detection(
        _copies(video_rig, str(tmp_path / "t")), detection_options=OPTIONS,
        aligned_frame_ixs=aligned, device="cpu")
    ref = jvideo.run_calibration_detection(
        _copies(video_rig, str(tmp_path / "j")), detection_options=OPTIONS,
        aligned_frame_ixs=aligned)
    assert got[1] == ref[1]
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(ref[0]))
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=UV_ATOL, equal_nan=True)
    # np.searchsorted over a column with NaN in the middle (JAX's mapping,
    # kept for parity) puts camera A's frame 4 into row 3 and camera B's
    # frames 9 and 10 both into row 7 (ROADMAP Queue 3).
    assert got[0].shape == (2, 14, 35, 2)
    summary = tvideo.summarize_detections(got[0])
    assert summary.equals(jvideo.summarize_detections(ref[0]))


def test_batched_and_per_frame_paths_agree(video_rig, tmp_path):
    path = _copies(video_rig, str(tmp_path))[0]
    use = np.arange(1, 12)  # 11 frames: batches of 4 pad the last one
    batched = tvideo._detect_video(path, detection_options=OPTIONS, use_frames=use,
                                   batch_size=4, device="cpu")
    single = tvideo._detect_video(path, detection_options=OPTIONS, use_frames=use,
                                  batch_size=0, device="cpu")
    np.testing.assert_array_equal(batched[1], single[1])
    assert set(batched[1]) <= set(use.tolist())
    np.testing.assert_allclose(batched[0], single[0], rtol=0, atol=1e-9)
    # f32 anchor scores: batch-size-dependent reduction order
    np.testing.assert_allclose(batched[3], single[3], rtol=0, atol=1e-6)
    assert tuple(batched[2]) == tuple(single[2]) == (640, 480)


def test_keyboard_interrupt_saves_partial_results(video_rig, tmp_path):
    from multicam_calibration_tpu_torch.detection import detector

    path = _copies(video_rig, str(tmp_path))[0]
    calls = []

    def interrupted(image, **options):
        calls.append(1)
        if len(calls) > 3:
            raise KeyboardInterrupt
        return detector.detect_chessboard(image, **options)

    out = tvideo.process_video(path, interrupted, {**OPTIONS, "device": "cpu"}, batch_size=0,
                               device="cpu")
    cache = _read_cache(out)
    assert len(calls) == 4 and 1 <= len(cache["frame_ixs"]) <= 3
    assert set(cache["frame_ixs"].tolist()) <= {0, 1, 2}


def test_no_board_raises_and_closes_the_reader(tmp_path, monkeypatch):
    import cv2

    path = str(tmp_path / "empty.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 240),
                             isColor=False)
    for k in range(4):
        writer.write(np.full((240, 320), 120 + 10 * k, np.uint8))
    writer.release()
    closed = []
    real_open = tvideo.open_video

    def tracking(p):
        reader = real_open(p)
        close = reader.close
        reader.close = lambda: (closed.append(True), close())
        return reader

    monkeypatch.setattr(tvideo, "open_video", tracking)
    with pytest.raises(ValueError, match="No detections found"):
        tvideo.process_video(path, detection_options=OPTIONS, device="cpu")
    assert closed == [True]
    assert not os.path.exists(str(tmp_path / "empty.detections.h5"))


def test_without_h5py_both_functions_raise(video_rig, tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        tvideo.process_video(video_rig["paths"][0], detection_options=OPTIONS, device="cpu")
    with pytest.raises(ImportError, match="needs h5py"):
        tvideo.run_calibration_detection(video_rig["paths"], detection_options=OPTIONS,
                                         device="cpu")


def test_open_video_names_its_backend(video_rig):
    reader = tvideo.open_video(video_rig["paths"][0])
    try:
        assert reader.backend == ("native" if tnv.available() else "cv2")
        assert len(reader) == 14 and reader[0].shape[:2] == (480, 640)
    finally:
        reader.close()
    cv2_reader = tvideo.VideoReader(video_rig["paths"][0])
    ref = jvideo.VideoReader(video_rig["paths"][0])
    for ix in (0, 1, 5, 2):  # sequential reads and seeks
        np.testing.assert_array_equal(cv2_reader[ix], ref[ix])
    cv2_reader.close()


def test_native_reader_and_writer_match_jax(video_rig, tmp_path):
    if not tnv.available():
        pytest.skip(f"the native video runtime does not build here: {tnv.build_error()}")
    from multicam_calibration_tpu.detection import native_video as jnv

    if not jnv.available():
        pytest.skip("the JAX package's libmccvideo is unavailable here")
    for gray in (True, False):
        with tnv.NativeVideoReader(video_rig["paths"][1], gray=gray) as got, \
                jnv.NativeVideoReader(video_rig["paths"][1], gray=gray) as ref:
            assert len(got) == len(ref) == 14
            a, b = got.read_batch(16), ref.read_batch(16)
            assert a.shape == b.shape and np.array_equal(a, b)
            np.testing.assert_array_equal(got[3], ref[3])
    frames = np.random.default_rng(0).integers(0, 255, (6, 48, 64), dtype=np.uint8)
    tnv.write_y4m(str(tmp_path / "a.y4m"), frames)
    jnv.write_y4m(str(tmp_path / "b.y4m"), frames)
    assert (tmp_path / "a.y4m").read_bytes() == (tmp_path / "b.y4m").read_bytes()
    with tnv.NativeVideoReader(str(tmp_path / "a.y4m"), gray=True) as r:
        np.testing.assert_array_equal(r.read_batch(6), frames)
    with tnv.NativeVideoWriter(str(tmp_path / "w.avi"), 64, 48, gray=True) as w:
        for f in frames:
            w.write(f)
    with tnv.NativeVideoReader(str(tmp_path / "w.avi"), gray=True) as r:
        assert r.read_batch(10).shape[0] == 6


def test_qc_plot_and_overlay_read_the_port_cache(caches, video_rig, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from multicam_calibration_tpu_torch import viz as tviz

    paths = _copies(video_rig, str(tmp_path))
    for p in paths:
        tvideo.process_video(p, detection_options=OPTIONS, device="cpu")
    fig = tviz.plot_chessboard_qc_data(paths)
    assert len(fig.axes) == 4
    plt.close(fig)
    if not (tnv.available() or _has("imageio")):
        pytest.skip("neither the native video runtime nor imageio to encode")
    out = tviz.overlay_detections(paths[0], output_path=str(tmp_path / "overlay.avi"),
                                  frame_range=(0, 5))
    reader = tvideo.open_video(out)
    try:
        assert len(reader) in (5, -1) or reader[4] is not None
    finally:
        reader.close()


def _has(module):
    try:
        __import__(module)
        return True
    except ImportError:
        return False
