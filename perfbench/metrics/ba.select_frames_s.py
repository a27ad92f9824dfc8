"""Seconds a ``bundle_adjust`` call spends selecting its frames (the
forward model at the start, the outlier cut and the subsample, mostly on
the host): the program's stage timer ``ba.select_frames`` over the traced
window, divided by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.select_frames", 0.0)
    return s / ctx["jobs"] if s > 0 else None
