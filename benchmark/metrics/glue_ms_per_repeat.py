"""Device milliseconds a repeat of every kernel that is not one of the
port's own (Adam, elementwise and reduction kernels, cuBLAS, copies): the
glue of ``algo/mappo.py`` and ``ops/fused_update.py``, less the check's
state ring (``ctx.harness_s``)."""


def read(ctx):
    s = sum(sec for name, _, sec in ctx.work.table if "marlnav" not in name)
    return 1e3 * (s / ctx.units - ctx.harness_s)
