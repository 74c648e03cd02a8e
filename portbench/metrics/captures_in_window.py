"""Graphs: CUDA-graph captures the program made inside the window
(``graphs.stats()["captures"]`` after it, less before it)."""


def read(ctx):
    return ctx.after["captures"] - ctx.before["captures"]
