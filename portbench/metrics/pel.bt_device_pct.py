"""Percent of the window's device time (kernels, copies, sets) in the
backtrace walk K9 (bowtie2_tpu_torch/csrc/backtrace.cu), from the
profiler's trace. In local mode every chosen candidate is walked (soft
clips need the walk), so K9 is a main device stage of the local PE
path."""

import os
import re

from portbench.trace import base_name

_K9 = "backtrace.cu"


def _kernels():
    """The __global__ functions of the port's csrc/backtrace.cu."""
    from bowtie2_tpu_torch.ops import _build

    path = os.path.join(os.path.dirname(_build.__file__), os.pardir,
                        "csrc", _K9)
    with open(path) as f:
        return set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            f.read()))


def read(ctx):
    if ctx.trace is None:
        return None
    total = sum(d for _n, _c, _s, d in ctx.trace.ops)
    k9 = _kernels()
    walk = sum(d for n, c, _s, d in ctx.trace.ops
               if c == "kernel" and base_name(n) in k9)
    return 100.0 * walk / total if total > 0 else None
