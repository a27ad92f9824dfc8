"""Seconds a pipeline spends in the intrinsics LM refine (on the card the
lockstep LM of every camera at once; on the CPU one solve a camera), the
repair's re-solves included: the program's span
``calibrate.intrinsics.refine`` over the traced window, divided by the
pipelines in it. Nothing where the program keeps no such span."""


def read(ctx):
    s = ctx["stage_times"].get("calibrate.intrinsics.refine", 0.0)
    return s / ctx["jobs"] if s > 0 else None
