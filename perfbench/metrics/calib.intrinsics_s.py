"""Seconds a pipeline's ``calibrate`` spends on the intrinsics of every
camera (Zhang's closed form and the LM refine, with the basin guard's
second refine where it flags a camera): the program's span
``calibrate.intrinsics`` over the traced window, divided by the pipelines
in it."""


def read(ctx):
    s = ctx["stage_times"].get("calibrate.intrinsics", 0.0)
    return s / ctx["jobs"] if s > 0 else None
