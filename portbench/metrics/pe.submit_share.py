"""Percent of the window the host spends in the PE entry's `submit`
(pipeline/paired.py PairedAligner.submit: padding, seed offsets, the
enqueue of fused_pe) less its child spans, by the port's own span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "submit")
