"""Host time of an update's pose initialisation, ms: the program's profiler
range ``rolling.pose_init`` (the new frames' batched planar PnP and their
consensus, ending in one host read) over the traced window, divided by the
updates in it."""


def read(ctx):
    ms = 1e3 * ctx["trace"].range_s("rolling.pose_init")
    return ms / ctx["jobs"] if ms > 0 else None
