"""Percent of the window's PE batches that ran on the host path
(pipeline/paired.py align_batch_host): the port's `host_batches` counter
over the batches collected."""


def read(ctx):
    return 100.0 * ctx.counters.get("host_batches", 0) / ctx.batches
