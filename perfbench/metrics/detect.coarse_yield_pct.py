"""Share of the frames entering a rung of the detector's coarse ladder that
the rung accepted, in %: the program's counters ``detect.coarse.accepted``
over ``detect.coarse.tried`` (both summed over rungs) in the traced window.
Nothing where no frame entered the ladder."""


def read(ctx):
    tried = ctx["stage_times"].get("detect.coarse.tried", 0)
    return 100.0 * ctx["stage_times"].get("detect.coarse.accepted", 0) / tried if tried else None
