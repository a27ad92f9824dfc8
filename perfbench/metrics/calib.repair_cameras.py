"""Cameras a pipeline's ``calibrate`` re-solves because their intrinsics
disagree with the rig: the program's counter ``calibrate.repair.cameras``
over the traced window, divided by the pipelines in it. 0 is a reading;
nothing where the program keeps no such counter."""


def read(ctx):
    n = ctx["stage_times"].get("calibrate.repair.cameras")
    return n / ctx["jobs"] if n is not None else None
