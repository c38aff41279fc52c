"""Percent of the window in the fused SE emission (pipeline/align.py
collect_raw after the blob's readback: replay overrides, the native
CIGAR/MD and line builder, the groups) less its child spans (the replay,
readbacks), by the port's `emit_fused` span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "emit_fused")
