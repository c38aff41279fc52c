"""Percent of the window in which no operation ran on the device (the
union of the profiler's kernel, copy and set intervals), PE cells."""


def read(ctx):
    return ctx.idle_pct()
