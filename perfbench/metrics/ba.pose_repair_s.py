"""Seconds a ``bundle_adjust`` call spends on its pose repair (flagging
frames far above the median error, re-initialising and re-solving them):
the program's stage timer ``ba.pose_repair`` over the traced window,
divided by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.pose_repair", 0.0)
    return s / ctx["jobs"] if s > 0 else None
