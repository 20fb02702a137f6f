"""The critic's gradient kernel (``tc_grad_kernel<CriticHead..>``): its
least time over its time a launch.  A launch takes one minibatch: its
steps x envs rows of A F inputs."""

from benchmark.counts import critic_grad
from benchmark.metrics._roofline import share


def read(ctx):
    n, s = ctx.work.kernels("tc_grad_kernel", "CriticHead")
    sh = ctx.shapes
    rows = sh["minibatch_steps"] * sh["envs"]
    n_in = sh["agents"] * sh["obs"]
    return share(n, s, critic_grad.ops(rows, n_in, sh["hidden"]),
                 critic_grad.nbytes(rows, n_in, sh["hidden"]),
                 critic_grad.PEAK)
