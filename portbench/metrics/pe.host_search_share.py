"""Percent of the window in the PE host path's uncapped candidate search
(pipeline/align.py _search_candidates: searches, SA resolve, dedupe, the
DP) less its child spans (readbacks), by the port's `host_search`
span."""

from portbench import port_spans


def read(ctx):
    return port_spans.self_share(ctx, "host_search")
