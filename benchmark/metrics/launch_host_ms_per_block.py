"""The host's milliseconds a block in the block runner's launch
(``_Blocks.graphed``: the seeds' writes, the replay or replays and the
pipelined copies of the block's rows), from the program's own span
``marlnav.block.launch``, which sums while a profiler records
(``utils.profiling.span_summary``).  Nothing where the program has no
such span."""


def read(ctx):
    from marlnav_tpu_torch.utils import profiling

    span_summary = getattr(profiling, "span_summary", None)
    if span_summary is None:
        return None
    span = span_summary().get("marlnav.block.launch")
    if not span or not span["count"]:
        return None
    return span["ms"] / span["count"]
