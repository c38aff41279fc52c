"""Percent of its roofline the rectangle DP without origins (csrc/
sw_rect.cu, entry `sw_rect`) reaches over the window: the mean least
time of its calls (work/dp.py: the larger of the bytes its live problems
need over the HBM bandwidth and their operations over the 32-bit integer
peak) over the mean time of its kernels in the profiler's trace."""


def read(ctx):
    return ctx.dp_roofline(origin=False)
