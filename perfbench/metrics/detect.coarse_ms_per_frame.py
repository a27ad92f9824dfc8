"""Host time of the detector's coarse ladder per frame: the program's span
``detect.finish.coarse`` (the three coarse-scale retries of the frames still
failing, each with its read-back and picks) over the traced window, in ms,
divided by the frames whose detections came back in it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("detect.finish.coarse", 0.0)
    return ms / ctx["units"] if ms > 0 and ctx["units"] else None
