"""Percent of the window the host spends in the SE entry's `collect_raw`
(pipeline/align.py UnpairedAligner.collect_raw), by the benchmark's
span around it."""


def read(ctx):
    return ctx.span_share("collect_raw")
