"""Host time of an update's planar pose start, ms: the program's span
``estimate_pose.homography`` (undistortion, board homographies and their
poses, batched over cameras) over the traced window, divided by the updates
in it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("estimate_pose.homography", 0.0)
    return ms / ctx["jobs"] if ms > 0 else None
