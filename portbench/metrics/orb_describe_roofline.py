"""Extraction kernel: the least time the descriptor needs over the traced
slice's frames (ORB bits, or at mdBRIEF the angle and blurred patches;
``reference/work.py``) as a share of the device time of the
``orb_describe.cu`` kernel (``describe``) there."""

KERNELS = r"(^|::)describe<"


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else 0.0
    if t <= 0:
        return None
    return 100.0 * ctx.least_seconds("describe") / t
