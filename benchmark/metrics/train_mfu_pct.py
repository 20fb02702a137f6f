"""Model FLOPs of the traced window's repeats (``counts/model_flops.py``)
over its wall time, as a share of the card's TF32 peak."""

from benchmark.counts import model_flops, peaks


def read(ctx):
    sh = ctx.shapes
    flops = ctx.units * model_flops.train_repeat(
        sh["envs"], sh["steps"], sh["agents"], sh["obs"], sh["hidden"],
        sh["actor_epochs"], sh["critic_epochs"])
    return 100.0 * flops / ctx.work.window_s / peaks.TF32_FLOPS
