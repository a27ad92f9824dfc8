"""ctypes binding of the native C++ video runtime: decode and encode.

Counterpart of ``multicam_calibration_tpu/detection/native_video.py``. The
decode runs in C++ (``csrc/video_loader.cc``): libavformat demux, libavcodec
decode and swscale GRAY8/BGR24 conversion on a background thread per video,
frames landing in a bounded ring buffer drained straight into numpy;
``csrc/video_writer.cc`` encodes in process. Both sources are the JAX
package's (``native/src/``), built at first use with the host C++ compiler
into ``_build/`` (``ops/_build.load_host_library``), linked against
libavformat, libavcodec, libavutil and libswscale.

``available()`` is False where that build fails (no libav headers or
libraries, no compiler); :func:`build_error` says why, and
``detection.video.open_video`` then serves frames with the cv2 reader, as
the JAX package does. The readers and writers raise where it is False.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

__all__ = ["available", "build_error", "NativeVideoReader", "NativeVideoWriter", "write_y4m"]

AV_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lpthread")


@functools.cache
def _libs():
    """(loader library, writer library, None) once built, or (None, None,
    the build's error text)."""
    from ..ops._build import load_host_library

    try:
        loader = load_host_library("video_loader", AV_LIBS).lib
        writer = load_host_library("video_writer", AV_LIBS).lib
    except (RuntimeError, OSError) as e:
        return None, None, str(e)
    _bind_loader(loader)
    _bind_writer(writer)
    return loader, writer, None


def _bind_loader(lib):
    lib.mccv_open.restype = ctypes.c_void_p
    lib.mccv_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.mccv_info.restype = ctypes.c_int
    lib.mccv_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.mccv_read.restype = ctypes.c_longlong
    lib.mccv_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong,
    ]
    lib.mccv_seek_frame.restype = ctypes.c_int
    lib.mccv_seek_frame.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.mccv_last_error.restype = ctypes.c_char_p
    lib.mccv_last_error.argtypes = [ctypes.c_void_p]
    lib.mccv_close.restype = None
    lib.mccv_close.argtypes = [ctypes.c_void_p]


def _bind_writer(lib):
    lib.mccw_open.restype = ctypes.c_void_p
    lib.mccw_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
    ]
    lib.mccw_open_ex.restype = ctypes.c_void_p
    lib.mccw_open_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int64,
    ]
    lib.mccw_write.restype = ctypes.c_int
    lib.mccw_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
    lib.mccw_close.restype = ctypes.c_int
    lib.mccw_close.argtypes = [ctypes.c_void_p]
    lib.mccw_last_error.restype = ctypes.c_char_p
    lib.mccw_last_error.argtypes = [ctypes.c_void_p]


def available() -> bool:
    """True when the native video runtime is built (or builds now)."""
    return _libs()[0] is not None


def build_error():
    """Why the native runtime is unavailable (the build's output), or None."""
    return _libs()[2]


def _lib(which):
    libs = _libs()
    if libs[0] is None:
        raise RuntimeError(f"the native video runtime is unavailable: {libs[2]}")
    return libs[which]


class NativeVideoReader:
    """Sequential batched reader over the C++ loader.

    API mirrors detection.video.VideoReader (len / index access) plus
    `read_batch(n)` which returns up to n frames as one (n, H, W[, 3])
    uint8 array — the natural unit for the batched detector.
    """

    backend = "native"

    def __init__(self, path, gray=False, prefetch=64):
        lib = _lib(0)
        self._lib = lib
        self._gray = bool(gray)
        self._h = lib.mccv_open(path.encode(), int(gray), int(prefetch))
        w = ctypes.c_int()
        hgt = ctypes.c_int()
        nf = ctypes.c_longlong()
        fps = ctypes.c_double()
        if lib.mccv_info(self._h, w, hgt, nf, fps) != 0:
            err = lib.mccv_last_error(self._h).decode()
            lib.mccv_close(self._h)
            self._h = None
            raise IOError(f"could not open video {path}: {err}")
        self.width = w.value
        self.height = hgt.value
        self._n = int(nf.value)  # -1 when the container doesn't say
        self.fps = fps.value
        self._next = 0
        self._frame_bytes = self.width * self.height * (1 if gray else 3)

    def __len__(self):
        if self._n >= 0:
            return self._n
        raise TypeError("frame count unknown for this container; iterate")

    @property
    def n_frames(self):
        return self._n

    def read_batch(self, n):
        shape = (
            (n, self.height, self.width)
            if self._gray
            else (n, self.height, self.width, 3)
        )
        buf = np.empty(shape, np.uint8)
        got = self._lib.mccv_read(
            self._h,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            n,
        )
        if got < 0:
            raise IOError(self._lib.mccv_last_error(self._h).decode())
        self._next += int(got)
        return buf[: int(got)]

    def __getitem__(self, ix):
        if ix != self._next:
            if self._lib.mccv_seek_frame(self._h, int(ix)) != 0:
                raise IOError(f"seek to frame {ix} failed")
            self._next = int(ix)
        out = self.read_batch(1)
        if out.shape[0] == 0:
            raise IndexError(f"failed to read frame {ix}")
        return out[0]

    def __iter__(self):
        while True:
            batch = self.read_batch(64)
            if batch.shape[0] == 0:
                return
            yield from batch

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.mccv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativeVideoWriter:
    """In-process video encoder over the C++ runtime
    (``csrc/video_writer.cc``): container picked from the path, encoder from
    the container (mpeg4/ffv1/rawvideo fallbacks), swscale conversion from
    BGR24/GRAY8 input frames."""

    def __init__(self, path, width, height, fps=30.0, gray=False,
                 bit_rate=None):
        """``bit_rate`` (bits/s) overrides the default generous-rate
        policy — used to encode at realistic lossy rates (the codec
        round-trip robustness suite)."""
        lib = _lib(1)
        self._lib = lib
        self.width, self.height = int(width), int(height)
        self._gray = bool(gray)
        if bit_rate:
            self._h = lib.mccw_open_ex(
                path.encode(), self.width, self.height, float(fps),
                int(gray), int(bit_rate),
            )
        else:
            self._h = lib.mccw_open(
                path.encode(), self.width, self.height, float(fps), int(gray)
            )
        # A failed open is detected on first write/close; probe eagerly.
        err = lib.mccw_last_error(self._h).decode()
        if err:
            lib.mccw_close(self._h)
            self._h = None
            raise IOError(f"could not open video writer {path}: {err}")

    def write(self, frame):
        frame = np.ascontiguousarray(frame, np.uint8)
        expect = (
            (self.height, self.width)
            if self._gray
            else (self.height, self.width, 3)
        )
        if frame.shape != expect:
            raise ValueError(f"frame shape {frame.shape} != {expect}")
        rc = self._lib.mccw_write(
            self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        )
        if rc != 0:
            raise IOError(self._lib.mccw_last_error(self._h).decode())

    append_data = write  # imageio-compatible spelling

    def close(self):
        if getattr(self, "_h", None) is not None:
            rc = self._lib.mccw_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("video writer close failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def write_y4m(path, frames, fps=30):
    """Write frames (uint8, (N,H,W) gray or (N,H,W,3) BGR) as YUV4MPEG2.

    Y4M is uncompressed and ffmpeg/OpenCV-readable — the fixture format for
    exercising the native loader without an encoder. BT.601 full-range
    ("C420jpeg") so gray frames round-trip through the Y plane exactly.
    """
    frames = np.asarray(frames, np.uint8)
    n, h, w = frames.shape[:3]
    if h % 2 or w % 2:
        raise ValueError("y4m 4:2:0 needs even dimensions")
    gray = frames.ndim == 3
    with open(path, "wb") as f:
        f.write(
            f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 C420jpeg "
            "XCOLORRANGE=FULL\n".encode()
        )
        for frame in frames:
            if gray:
                y = frame
                u = np.full((h // 2, w // 2), 128, np.uint8)
                v = u
            else:
                bgr = frame.astype(np.float32)
                b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
                y = np.clip(0.114 * b + 0.587 * g + 0.299 * r, 0, 255)
                uf = np.clip(128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b, 0, 255)
                vf = np.clip(128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b, 0, 255)
                y = y.astype(np.uint8)
                u = uf[::2, ::2].astype(np.uint8)
                v = vf[::2, ::2].astype(np.uint8)
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
