"""Percent of the window the host spends in the PE entry's `collect_raw`
(pipeline/paired.py PairedAligner.collect_raw), by the benchmark's span
around it."""


def read(ctx):
    return ctx.span_share("collect_raw")
