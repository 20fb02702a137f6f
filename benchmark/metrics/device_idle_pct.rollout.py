"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of their intervals; the collect's CUDA-event time
added where the profiler did not list it)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.work.busy_s / ctx.work.window_s)
