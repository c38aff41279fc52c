"""Percent of the window the host waits on the card in PE cells: the
port's `fetch` spans (pipeline/align.py _np, every readback of a result
from the device)."""

from portbench import port_spans


def read(ctx):
    return port_spans.share(ctx, "fetch")
