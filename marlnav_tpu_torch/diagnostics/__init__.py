"""Diagnostics: the reward-check harness and the trajectory renderer.

Port of ``marlnav_tpu/diagnostics``.  Both roll the whole trajectory out
first, on the env's device, and fetch the stacked frames once; plotting
and animation then run from host arrays (the reference steps the env per
frame with per-step device-to-host copies, reference animation.py:40-71,
utils.py:595-614).
"""

from marlnav_tpu_torch.diagnostics.trajectory import (Trajectory,
                                                      rollout_trajectory)
from marlnav_tpu_torch.diagnostics.reward_check import check_rews
from marlnav_tpu_torch.diagnostics.animation import (Animation, init_render,
                                                     load_actor_weights)

__all__ = ["Animation", "Trajectory", "check_rews", "init_render",
           "load_actor_weights", "rollout_trajectory"]
