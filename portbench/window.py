"""The timed window: the port's CLI pattern of submits and collects
(bowtie2_tpu_torch/cli/main.py, pipelined dispatch), and the rule that
turns it into a rate."""

import collections
import time


def drive(submit, collect, batch_at, depth, seconds,
          clock=time.perf_counter):
    """Submit batch after batch, collecting the oldest once more than
    `depth` are in flight, until the first collect that returns
    `seconds` or more after the start. batch_at(k) gives batch k as
    (units, names, records). Returns (collected [(units, output, names)],
    the batches still in flight, start, end, the time each collect
    returned)."""
    collected, pend, marks = [], collections.deque(), []
    t0 = clock()
    k = 0
    while True:
        units, names, recs = batch_at(k)
        pend.append((units, names, submit(recs)))
        k += 1
        if len(pend) > depth:
            units, names, h = pend.popleft()
            collected.append((units, collect(h), names))
            t1 = clock()
            marks.append(t1)
            if t1 - t0 >= seconds:
                return collected, pend, t0, t1, marks


def rate(collected, t0, t1):
    """Every unit of every batch collected over the window's length."""
    return sum(len(u) for u, _g, _n in collected) / (t1 - t0)
