"""Shared arithmetic of the roofline readers: a kernel's share of its
least time, from its device seconds and launches in the traced window."""

from benchmark.counts import peaks


def share(launches: int, seconds: float, ops: float, nbytes: float,
          flops_per_s: float):
    """Per cent of the least time a launch could take, or None where the
    trace holds no launch."""
    if launches == 0 or seconds <= 0:
        return None
    least = peaks.least_seconds(ops, nbytes, flops_per_s)
    return 100.0 * least / (seconds / launches)
