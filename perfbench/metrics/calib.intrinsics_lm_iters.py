"""Intrinsics LM iterations a pipeline drives from the host (a lockstep
refine counts its slowest camera's iterations; a per-camera solve, as the
repair's, its own): the program's counter ``calibrate.intrinsics.lm_iters``
over the traced window, divided by the pipelines in it. Nothing where the
program keeps no such counter."""


def read(ctx):
    n = ctx["stage_times"].get("calibrate.intrinsics.lm_iters")
    return n / ctx["jobs"] if n is not None else None
