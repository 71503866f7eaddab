"""Kernel B1's share of its roofline in the traced window: the least time
of the launches it ran (``counts.sample_loop`` from their rows and steps)
over its kernels' time in the device trace, in %."""
from pb.trace import kernel_time


def read(ctx):
    if not ctx.get("b1_launches"):
        return None
    seconds, launches = kernel_time(ctx["trace"], "wavernn_tile")
    if not launches or launches != len(ctx["b1_launches"]):
        return None
    return 100.0 * ctx["b1_bound_s"] / seconds
