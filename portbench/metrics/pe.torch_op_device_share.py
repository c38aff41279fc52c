"""Percent of the window's device time spent in kernels that are not the
port's own (bowtie2_tpu_torch/csrc): the torch operations of the fused PE
pipeline (ops/fused.py fused_pe), over all device time (kernels, copies,
sets), from the profiler's trace."""


def read(ctx):
    return ctx.torch_op_share()
