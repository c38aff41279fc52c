"""Percent of the window in the PE host path's own work (pipeline/
paired.py align_batch_host less its child spans: the pairing passes over
the mates' candidates and the -D effort model), by the self time of the
port's `host_path` span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "host_path")
