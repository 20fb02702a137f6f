"""Launches a repeat of every device operation that is not one of the
port's own kernels (it repeats exactly), less the check's state ring
(``ctx.harness_kernels``)."""


def read(ctx):
    n = sum(c for name, c, _ in ctx.work.table if "marlnav" not in name)
    return n / ctx.units - ctx.harness_kernels
