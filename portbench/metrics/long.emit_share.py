"""Percent of the window the host spends emitting long reads' records
(pipeline/align.py BatchAligner._emit_aligned), by the benchmark's span
around it."""


def read(ctx):
    return ctx.span_share("_emit_aligned")
