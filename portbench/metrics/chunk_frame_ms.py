"""Tracker, chunk path: host ms a frame of ``Tracker.track_chunk``'s scan
(its ``working_chunk`` timer, which ends in the chunk's one fetch), over
the frames the window's chunks accepted."""


def read(ctx):
    seconds = ctx.added("timers", "working_chunk")
    frames = ctx.added("frame_path").count("chunk")
    if not seconds or not frames:
        return None
    return sum(seconds) * 1e3 / frames
