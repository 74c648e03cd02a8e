"""Local mapping: mean wall ms of the mapping passes of the window
(``MultiColSLAM.mapping_ms``). One reader for ``mapping_ms.batch`` (cells
fed through ``track_batch``) and ``mapping_ms.live`` (fed frame by frame
through ``track``), which move different end-to-end metrics."""


def read(ctx):
    ms = ctx.added("mapping_ms")
    return sum(ms) / len(ms) if ms else None
