"""Seconds a pipeline's ``calibrate`` spends on the extrinsics (the maximum
spanning tree over co-detections and the chain of median pairwise
transforms along it): the program's span ``calibrate.extrinsics`` over the
traced window, divided by the pipelines in it."""


def read(ctx):
    s = ctx["stage_times"].get("calibrate.extrinsics", 0.0)
    return s / ctx["jobs"] if s > 0 else None
