"""Percent of the window in the PE host path's record building
(pipeline/paired.py align_batch_host's per-pair emission: _emit_pair,
_emit_aligned, MAPQ), by the self time of the port's `host_emit`
span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "host_emit")
