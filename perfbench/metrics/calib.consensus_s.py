"""Seconds a pipeline's ``calibrate`` spends on the consensus board poses
(the median world pose of every frame across cameras): the program's span
``calibrate.consensus`` over the traced window, divided by the pipelines
in it."""


def read(ctx):
    s = ctx["stage_times"].get("calibrate.consensus", 0.0)
    return s / ctx["jobs"] if s > 0 else None
