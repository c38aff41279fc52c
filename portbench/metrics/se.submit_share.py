"""Percent of the window the host spends in the SE entry's `submit`
(pipeline/align.py UnpairedAligner.submit: padding, seed offsets, the
enqueue of fused_se) less its child spans, by the port's own span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "submit")
