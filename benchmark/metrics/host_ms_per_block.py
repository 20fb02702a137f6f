"""The host's milliseconds a block in the runner's call
(``_Blocks.graphed``: the seeds' write and the replay launches), from the
harness's own clock around the call; the read that waits for the device
is left out."""

import statistics


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * statistics.fmean(ctx.spans)
