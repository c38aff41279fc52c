"""Percent of the window in mate rescue (pipeline/paired.py: the DP over
the opposite mate's window for a pair without a concordant combination,
on the fused paths and the host path), by the self time of the port's
`rescue` span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "rescue")
