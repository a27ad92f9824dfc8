"""Seconds a ``bundle_adjust`` call spends in its float64 polish: the
program's stage timer ``ba.f64_polish`` over the traced window, divided by
the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.f64_polish", 0.0)
    return s / ctx["jobs"] if s > 0 else None
