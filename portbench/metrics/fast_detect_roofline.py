"""Extraction kernel: the least time detection needs over the traced
slice's frames (bytes over the memory's rate or instructions over the
float32 rate, the larger, counted from those frames by
``reference/work.py``) as a share of the device time of the
``fast_detect.cu`` kernels (``cell_flags``, ``tile_maxima``) there."""

KERNELS = r"(^|::)(cell_flags|tile_maxima)(<|$)"


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else 0.0
    if t <= 0:
        return None
    return 100.0 * ctx.least_seconds("detect") / t
