"""Megabytes (10**6 bytes) a ``bundle_adjust`` call reads back from the
device in its frame selection, its preparation and its pose repair's flag:
the program's counter ``ba.readback_bytes`` over the traced window, divided
by the calls in it. Nothing where the program keeps no such counter."""


def read(ctx):
    n = ctx["stage_times"].get("ba.readback_bytes")
    return n / 1e6 / ctx["jobs"] if n is not None else None
