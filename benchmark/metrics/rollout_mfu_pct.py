"""Model FLOPs of the traced window's rollout calls (the actor's forward
on every agent of every env-step, ``counts/model_flops.py``) over its wall
time, as a share of the card's TF32 peak."""

from benchmark.counts import model_flops, peaks


def read(ctx):
    sh = ctx.shapes
    flops = (ctx.units * sh["envs"] * sh["steps"]
             * model_flops.rollout_env_step(sh["agents"], sh["obs"],
                                            sh["hidden"]))
    return 100.0 * flops / ctx.work.window_s / peaks.TF32_FLOPS
