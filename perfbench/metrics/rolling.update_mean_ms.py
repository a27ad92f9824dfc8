"""Mean time of an update in the traced window, ms: the window over the
updates in it. It sits beside the tail, ``update_p90_ms``, as the steadier
reading; it decides nothing."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["jobs"] if ctx["jobs"] else None
