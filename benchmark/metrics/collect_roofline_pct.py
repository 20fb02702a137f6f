"""The collect kernel (``fused_collect_kernel``): its least time over its
time a launch, one launch a repeat of T steps of P envs.  Its time is the
profiler's where the trace lists the kernel, else the harness's own CUDA
events over launches at the cell's shape (``ctx.collect_s``)."""

from benchmark.counts import collect
from benchmark.metrics._roofline import share


def read(ctx):
    n, s = ctx.work.kernels("fused_collect")
    if n == 0 and ctx.collect_s is not None:
        n, s = 1, ctx.collect_s
    sh = ctx.shapes
    args = (sh["envs"], sh["steps"], sh["obstacles"])
    return share(n, s, collect.ops(*args), collect.nbytes(*args),
                 collect.PEAK)
