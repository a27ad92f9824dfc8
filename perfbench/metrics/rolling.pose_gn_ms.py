"""Host time of an update's pose polish, ms: the program's span
``estimate_pose.gauss_newton`` (both Gauss-Newton branches of the planar
ambiguity and the choice between them, batched over cameras) over the
traced window, divided by the updates in it."""


def read(ctx):
    ms = 1e3 * ctx["stage_times"].get("estimate_pose.gauss_newton", 0.0)
    return ms / ctx["jobs"] if ms > 0 else None
