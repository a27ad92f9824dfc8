"""Seconds a ``bundle_adjust`` call's frame selection spends in numpy (the
detected-frame mask, the reprojection errors, the outlier cut and the
subsample): the program's span ``ba.select_frames.host`` over the traced
window, divided by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.select_frames.host", 0.0)
    return s / ctx["jobs"] if s > 0 else None
