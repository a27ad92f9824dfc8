"""Seconds a ``bundle_adjust`` call's frame selection spends on the forward
model at the start and its read-back to the host: the program's span
``ba.select_frames.predict`` over the traced window, divided by the calls
in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.select_frames.predict", 0.0)
    return s / ctx["jobs"] if s > 0 else None
