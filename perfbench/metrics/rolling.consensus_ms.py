"""Host time of an update's pose consensus, ms: the program's span
``consensus_calib_poses`` (the masked median of the cameras' world-frame
board poses) over the traced window, divided by the updates in it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("consensus_calib_poses", 0.0)
    return ms / ctx["jobs"] if ms > 0 else None
