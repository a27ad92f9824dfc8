"""Host time of the detector's lattice search per frame: the program's span
``detect.finish.lattice`` (``order_grid_points`` over the frames the device
ordering did not certify) over the traced window, in ms, divided by the
frames whose detections came back in it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("detect.finish.lattice", 0.0)
    return ms / ctx["units"] if ms > 0 and ctx["units"] else None
