"""Seconds a ``bundle_adjust`` call spends preparing its solve (the selected
frames' observations and masks on the host, their upload in float64, the
options): the program's span ``ba.prepare`` over the traced window, divided
by the calls in it."""


def read(ctx):
    s = ctx["stage_times"].get("ba.prepare", 0.0)
    return s / ctx["jobs"] if s > 0 else None
