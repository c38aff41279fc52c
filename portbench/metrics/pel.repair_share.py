"""Percent of the window in the PE host re-pairing (pipeline/paired.py
_collect_fused_legacy: the pairing, the -D effort model and the
emission of a batch whose device pairing flagged a pair, re-run on the
host from the per-slot export) less its child spans (mate rescue, the
walks, readbacks), by the port's `repair_host` span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "repair_host")
