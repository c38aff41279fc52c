"""Percent of the window in the long-read path's record building
(pipeline/align.py _align_batch_host's per-read emission: _emit_aligned,
MAPQ), by the self time of the port's `host_emit` span: the same work as
long.emit_share, which times `_emit_aligned` from outside, plus the
loop around it."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "host_emit")
