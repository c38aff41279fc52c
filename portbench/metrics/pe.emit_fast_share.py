"""Percent of the window in the fused PE emission (pipeline/paired.py
_collect_fused_fast_raw: the device pairing's decisions decoded, the
native line builder) less its child spans (mate rescue, backtrace,
readbacks), by the port's `emit_fast` span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "emit_fast")
