"""Host time of the detector's host half per frame: the program's profiler
range ``detect_chessboard_batches.finish`` over the traced window, in ms,
divided by the frames whose detections came back in it."""


def read(ctx):
    ms = 1e3 * ctx["trace"].range_s("detect_chessboard_batches.finish")
    return ms / ctx["units"] if ms > 0 and ctx["units"] else None
