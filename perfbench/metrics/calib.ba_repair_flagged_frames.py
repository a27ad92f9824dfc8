"""Frames the pose repair of a pipeline's ``bundle_adjust`` flags as far
above the median error: the program's counter ``ba.pose_repair.flagged``
over the traced window, divided by the pipelines in it. 0 is a reading;
nothing where the program keeps no such counter."""


def read(ctx):
    n = ctx["stage_times"].get("ba.pose_repair.flagged")
    return n / ctx["jobs"] if n is not None else None
