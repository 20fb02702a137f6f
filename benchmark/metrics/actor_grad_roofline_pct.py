"""The actor's gradient kernel through its affine operator
(``actor_grad_kernel``): its least time over its time a launch.  A launch
takes one minibatch: its steps x envs x agents rows."""

from benchmark.counts import actor_grad
from benchmark.metrics._roofline import share


def read(ctx):
    n, s = ctx.work.kernels("actor_grad_kernel")
    sh = ctx.shapes
    rows = sh["minibatch_steps"] * sh["envs"] * sh["agents"]
    return share(n, s, actor_grad.ops(rows, sh["obs"]),
                 actor_grad.nbytes(rows, sh["obs"]), actor_grad.PEAK)
