"""Host time of the detector's upload and stage-1 dispatch per frame: the
program's profiler range ``detect_chessboard_batches.dispatch`` over the
traced window, in ms, divided by the frames whose detections came back in
it (the window also dispatches the batch after its last)."""


def read(ctx):
    ms = 1e3 * ctx["trace"].range_s("detect_chessboard_batches.dispatch")
    return ms / ctx["units"] if ms > 0 and ctx["units"] else None
