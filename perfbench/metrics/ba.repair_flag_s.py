"""Seconds a ``bundle_adjust`` call's pose repair spends finding the frames
to repair (the residuals, their read-back and the per-frame median test):
the program's span ``ba.pose_repair.flag`` over the traced window, divided
by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.pose_repair.flag", 0.0)
    return s / ctx["jobs"] if s > 0 else None
