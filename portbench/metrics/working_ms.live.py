"""Tracker, per-frame path: mean host ms of a fused WORKING frame (the
tracker's ``working_fused`` timer, which ends in the frame's fetch) over
the window."""


def read(ctx):
    seconds = ctx.added("timers", "working_fused")
    return sum(seconds) * 1e3 / len(seconds) if seconds else None
