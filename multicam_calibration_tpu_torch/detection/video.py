"""Video-level detection with per-video HDF5 caching.

Counterpart of ``multicam_calibration_tpu/detection/video.py``, with its
signatures, cache format and semantics. The host decodes frames into
fixed-size batches and the device runs the batched detector
(``detect_chessboard_batches``: the corner kernel and the rest of stage 1 on
the card, one batch of lookahead); only the lattice decisions run on the
host. The cache, ``{video}.detections.h5`` with ``uvs`` / ``frame_ixs`` /
``img_size`` / ``qc_data``, is the JAX package's and the reference's, so
caches interoperate; it needs ``h5py``, and :func:`process_video` and
:func:`run_calibration_detection` raise ``ImportError`` without it rather
than skip the cache. :func:`_detect_video` (one video's detections) and
:func:`_assemble_aligned` (the NaN-padded camera x frame array) are the
cache-free halves of those two.
"""
from __future__ import annotations

import os

import numpy as np

from ..device import resolve_device
from ..utils.io import require_h5py
from .detector import detect_chessboard, detect_chessboard_batches

__all__ = [
    "VideoReader",
    "open_video",
    "process_video",
    "run_calibration_detection",
    "summarize_detections",
]

# The default batch on every device: the JAX package's off the TPU. On the
# H100, chip_smoke.py phase 20 finds 64, 128 and 256 within run-to-run noise
# of each other, the path being host-bound (PERF.md §6).
BATCH_SIZE = 64


def _h5py():
    return require_h5py("the {video}.detections.h5 detection cache")


def _cache_path(video_path):
    return os.path.splitext(video_path)[0] + ".detections.h5"


def open_video(path, gray=False, prefetch=64):
    """Open a video with the best available backend.

    Prefers the native C++ loader (``native_video.NativeVideoReader``:
    libavformat decode on a background thread) and falls back to the cv2
    ``VideoReader`` where the native runtime is unavailable or cannot read
    the container. The reader's ``backend`` attribute says which one serves
    ("native" or "cv2"). Returns an object supporting len() and frame
    indexing; the native reader additionally supports read_batch().
    """
    from .native_video import NativeVideoReader, available

    if available():
        try:
            reader = NativeVideoReader(path, gray=gray, prefetch=prefetch)
        except IOError:
            reader = None  # container the native build can't read -> cv2
        if reader is not None:
            if reader.n_frames >= 0:
                return reader
            # Index-less container (no frame count): callers need len();
            # prefer the cv2 reader, keep the native one as last resort.
            try:
                cv2_reader = VideoReader(path)
            except Exception:
                return reader
            reader.close()
            return cv2_reader
    return VideoReader(path)


class VideoReader:
    """Minimal random-access video reader over cv2.VideoCapture (BGR
    frames; sequential reads never seek). ``api`` names OpenCV's backend."""

    backend = "cv2"

    def __init__(self, path):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"could not open video {path}")
        self.api = self._cap.getBackendName()
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._next = 0
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0

    def __len__(self):
        return self._n

    def __getitem__(self, ix):
        import cv2

        if ix != self._next:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, int(ix))
        ok, frame = self._cap.read()
        self._next = ix + 1
        if not ok:
            raise IndexError(f"failed to read frame {ix}")
        return frame

    def close(self):
        self._cap.release()


def _detect_video(
    video_path,
    detection_fun=detect_chessboard,
    detection_options=None,
    use_frames=None,
    frames=None,
    img_size=None,
    batch_size=None,
    device=None,
):
    """One video's detections, without the cache: ``(uvs (n_det, N, 2),
    frame_ixs (n_det,), img_size (w, h), qc_data (n_det, 4) or None)``.

    The default detector runs in batches of ``batch_size`` frames through
    ``detect_chessboard_batches`` (the last batch's tail padded by repeating
    its last frame, as the JAX package does); ``batch_size`` 0 or 1, or
    another ``detection_fun``, runs frame by frame. A KeyboardInterrupt
    keeps what was detected so far; the reader is closed in any case.
    Raises ``ValueError("No detections found")`` when nothing was found.
    """
    dev = resolve_device(device)
    if batch_size is None:
        batch_size = BATCH_SIZE
    options = dict(detection_options or {})
    if detection_fun is detect_chessboard:
        options.setdefault("device", dev)
    reader = None
    if frames is None:
        reader = open_video(video_path)
        first = reader[0]
        img_size = first.shape[:2][::-1]
        total = len(reader)
        get = lambda ix: reader[ix]  # noqa: E731
    else:
        img_size = img_size or frames[0].shape[:2][::-1]
        total = len(frames)
        get = lambda ix: frames[ix]  # noqa: E731

    if use_frames is None:
        use_frames = np.arange(total)

    batched = detection_fun is detect_chessboard and batch_size and batch_size > 1

    detections = {}
    try:
        if batched:
            use = np.asarray(use_frames, int)
            chunks = [use[lo : lo + batch_size] for lo in range(0, len(use), batch_size)]

            def _batches():
                for chunk in chunks:
                    imgs = [get(int(ix)) for ix in chunk]
                    while len(imgs) < batch_size:  # pad tail: constant shape
                        imgs.append(imgs[-1])
                    yield imgs

            # Batch k + 1 is decoded and its device stage dispatched before
            # batch k's host half runs.
            for chunk, found in zip(chunks, detect_chessboard_batches(_batches(), **options)):
                for j, det in found.items():
                    if j < len(chunk):
                        detections[int(chunk[j])] = det
        else:
            for frame_ix in use_frames:
                det = detection_fun(get(int(frame_ix)), **options)
                if det is not None:
                    detections[int(frame_ix)] = det
    except KeyboardInterrupt:
        print("Early termination, saving results so far...")
    finally:
        if reader is not None and hasattr(reader, "close"):
            reader.close()

    if len(detections) == 0:
        raise ValueError("No detections found")

    frame_ixs = np.array(sorted(detections.keys()))
    first = detections[frame_ixs[0]]
    if isinstance(first, tuple) and len(first) == 2:
        uvs = np.stack([detections[i][0] for i in frame_ixs])
        qc_data = np.stack([detections[i][1] for i in frame_ixs])
    else:
        uvs = np.stack([detections[i] for i in frame_ixs])
        qc_data = None
    return uvs, frame_ixs, img_size, qc_data


def process_video(
    video_path,
    detection_fun=detect_chessboard,
    detection_options=None,
    use_frames=None,
    n_workers=1,
    frames=None,
    img_size=None,
    batch_size=None,
    device=None,
):
    """Detect the calibration object in one video; cache to HDF5.

    Writes ``{video}.detections.h5`` with ``uvs (n_det, N, 2)``,
    ``frame_ixs``, ``img_size`` and (when the detector returns scores)
    ``qc_data``, and returns its path. ``n_workers`` is accepted for parity
    (the device pipeline replaces the process pool); ``frames`` passes
    pre-decoded frames instead of reading ``video_path``. The detection is
    :func:`_detect_video`'s (batches on the device, ``batch_size=0`` frame
    by frame, a partial save on KeyboardInterrupt). ``device=None`` runs on
    the CUDA device and raises without one; without ``h5py`` this raises
    ``ImportError`` before any work.
    """
    del n_workers
    h5py = _h5py()
    uvs, frame_ixs, img_size, qc_data = _detect_video(
        video_path, detection_fun, detection_options, use_frames, frames,
        img_size, batch_size, device,
    )
    save_path = _cache_path(video_path)
    with h5py.File(save_path, "w") as h5:
        h5.create_dataset("uvs", data=uvs)
        h5.create_dataset("frame_ixs", data=frame_ixs)
        h5.create_dataset("img_size", data=np.asarray(img_size))
        if qc_data is not None:
            h5.create_dataset("qc_data", data=qc_data)
    return save_path


def _assemble_aligned(all_uvs, all_frame_ixs, aligned_frame_ixs):
    """The NaN-padded (n_cameras, n_framesets, N, 2) detections: camera i's
    detection of frame ``all_frame_ixs[i][k]`` lands in the row of
    ``aligned_frame_ixs[:, i]`` (NaN = not recorded) that holds that frame
    index, found by ``np.searchsorted`` as in the JAX package."""
    assert np.all([len(u) > 0 for u in all_uvs]), "At least one video has no detections"
    aligned_frame_ixs = np.asarray(aligned_frame_ixs)
    n_calib_points = all_uvs[0].shape[1]
    n_frames = aligned_frame_ixs.shape[0]
    all_calib_uvs = np.full((len(all_uvs), n_frames, n_calib_points, 2), np.nan)
    for i, (uvs, frame_ixs) in enumerate(zip(all_uvs, all_frame_ixs)):
        order = np.argsort(frame_ixs)
        uvs = uvs[order]
        frame_ixs = np.sort(frame_ixs)
        slots = np.searchsorted(aligned_frame_ixs[:, i], frame_ixs)
        all_calib_uvs[i, slots] = uvs
    return all_calib_uvs


def run_calibration_detection(
    video_paths,
    detection_fun=detect_chessboard,
    detection_options=None,
    aligned_frame_ixs=None,
    overwrite=False,
    n_workers=1,
    all_frames=None,
    device=None,
):
    """Detect over a camera set; returns (all_calib_uvs, img_sizes).

    Per-video caches are reused unless ``overwrite``;
    ``aligned_frame_ixs (n_framesets, n_cameras)`` maps simultaneous frames
    across cameras (NaN = dropped); the output is the NaN-padded
    (n_cameras, n_framesets, N, 2) array of :func:`_assemble_aligned`.
    ``all_frames`` optionally supplies pre-decoded frames per camera.
    ``device=None`` runs on the CUDA device and raises without one; without
    ``h5py`` this raises ``ImportError``.
    """
    h5py = _h5py()
    dev = resolve_device(device)
    if aligned_frame_ixs is None:
        if all_frames is not None:
            n_frames = min(len(f) for f in all_frames)
        else:
            lengths = []
            for vp in video_paths:
                reader = open_video(vp)
                lengths.append(len(reader))
                reader.close()
            n_frames = min(lengths)
        aligned_frame_ixs = np.stack([np.arange(n_frames)] * len(video_paths)).T

    all_uvs, all_img_sizes, all_frame_ixs = [], [], []
    for i, video_path in enumerate(video_paths):
        save_path = _cache_path(video_path)
        if overwrite or not os.path.exists(save_path):
            print(f"Processing {video_path}")
            use = aligned_frame_ixs[:, i]
            use = use[~np.isnan(use)].astype(int)
            process_video(
                video_path, detection_fun, detection_options, use, n_workers,
                frames=None if all_frames is None else all_frames[i], device=dev,
            )
        with h5py.File(save_path, "r") as h5:
            all_uvs.append(h5["uvs"][:])
            all_img_sizes.append(tuple(h5["img_size"][:]))
            all_frame_ixs.append(h5["frame_ixs"][:])
    return _assemble_aligned(all_uvs, all_frame_ixs, aligned_frame_ixs), all_img_sizes


def summarize_detections(all_calib_uvs):
    """Pairwise shared-detection counts as a DataFrame."""
    import pandas as pd

    has_detection = ~np.isnan(np.asarray(all_calib_uvs)).any(axis=(2, 3))
    n_shared = (has_detection[:, None, :] & has_detection[None, :, :]).sum(2)
    names = [f"Camera {i}" for i in range(len(all_calib_uvs))]
    return pd.DataFrame(n_shared, index=names, columns=names)
