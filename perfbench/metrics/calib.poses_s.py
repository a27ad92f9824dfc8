"""Seconds a pipeline's ``calibrate`` spends on every camera's board poses
(planar PnP in slabs of camera-frames, the polish through
``pose_gn_kernel`` on the card): the program's span ``calibrate.poses``
over the traced window, divided by the pipelines in it."""


def read(ctx):
    s = ctx["stage_times"].get("calibrate.poses", 0.0)
    return s / ctx["jobs"] if s > 0 else None
