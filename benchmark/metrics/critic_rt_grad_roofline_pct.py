"""The critic's gradient through the run-time-width route
(``rt_forward_kernel`` and ``rt_backward_kernel`` with ``kActor`` false,
then ``reduce_partials_kernel``): the least time of one critic gradient
(``counts/critic_grad.py``, the same work ``critic_grad_roofline_pct``
counts) over the route's device time a gradient.  A gradient is one
forward launch.  The reduction kernel is shared with the templated
instances and the actor's route, so the route is given the mean time of
a reduction for each of its forward launches.  Nothing where the trace
holds no such launch."""

from benchmark.counts import critic_grad
from benchmark.metrics._roofline import share


def read(ctx):
    work = ctx.work
    n, fwd_s = work.kernels("rt_forward_kernel<false")
    _, bwd_s = work.kernels("rt_backward_kernel<false")
    n_red, red_s = work.kernels("reduce_partials_kernel")
    if n and n_red:
        fwd_s += red_s * min(n, n_red) / n_red
    sh = ctx.shapes
    rows = sh["minibatch_steps"] * sh["envs"]
    n_in = sh["agents"] * sh["obs"]
    return share(n, fwd_s + bwd_s, critic_grad.ops(rows, n_in, sh["hidden"]),
                 critic_grad.nbytes(rows, n_in, sh["hidden"]),
                 critic_grad.PEAK)
