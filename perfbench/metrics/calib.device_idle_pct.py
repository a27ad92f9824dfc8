"""Share of the traced window in which no kernel, copy or memset ran on
the device, in %, over whole ``calibrate`` -> ``bundle_adjust`` pipelines."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_s > 0 else None
