"""The rollout kernel (``fused_rollout_kernel``): its least time over its
time a launch, one launch a call of T steps of P envs."""

from benchmark.counts import rollout
from benchmark.metrics._roofline import share


def read(ctx):
    n, s = ctx.work.kernels("fused_rollout")
    sh = ctx.shapes
    return share(n, s, rollout.ops(sh["envs"], sh["steps"], sh["obstacles"],
                                   sh["policy_mean"]),
                 rollout.nbytes(sh["envs"], sh["steps"], sh["obstacles"]),
                 rollout.PEAK)
