"""Seconds a ``bundle_adjust`` call spends in its mixed-precision solve:
the program's stage timer ``ba.lm_solve`` over the traced window, divided
by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.lm_solve", 0.0)
    return s / ctx["jobs"] if s > 0 else None
