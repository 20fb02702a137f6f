"""Whole-trajectory rollout, fetched once.

Port of ``marlnav_tpu/diagnostics/trajectory.py``.  ``rollout_trajectory``
steps the env ``num_steps`` times with actions from its scripted sampler
(reference utils.py:595-597) or from a policy (its mean, or samples,
reference animation.py:42-50), and returns time-stacked host arrays: the
renderer and the reward-check harness consume a finished trajectory
instead of stepping the device per frame.  The JAX package runs the steps
as one jitted scan; here they are a Python loop of the env's own step on
its device, which reads nothing back: the frames stay on the device,
stacked at the end and copied to the host in one transfer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from marlnav_tpu_torch.env.env import Env
from marlnav_tpu_torch.env.types import Observations


class Trajectory(NamedTuple):
    """Time-stacked rollout record, as host numpy arrays.

    states (T, P, A, 5), obstacles (T, P, O, 2), target (T, P, 1, 2): the
    POST-step state of each frame (what the renderer draws, reference
    animation.py:64-69).  obs and rewards are the step's outputs
    (post-reinit observations, pre-reinit rewards, reference
    environment.py:92-107).
    """

    states: np.ndarray
    obstacles: np.ndarray
    target: np.ndarray
    obs: Observations  # leaves (T, P, A, K)
    rewards: np.ndarray  # (T, P)
    terminated: np.ndarray  # (T, P) bool
    truncated: np.ndarray  # (T, P) bool


_OBS_FIELDS = ("target_angle", "target_distance", "obstacles_angles",
               "obstacles_distances", "others_angles", "others_distances")


def _fetch(frames) -> list:
    """Each entry of ``frames`` (a list of same-shaped tensors a field)
    stacked on the device, then every field copied to the host in one
    transfer (bool fields as float32 and back)."""
    stacked = [torch.stack(f) for f in frames]
    flat = torch.cat([s.reshape(-1).to(torch.float32) for s in stacked])
    host = flat.cpu().numpy()
    out, start = [], 0
    for s in stacked:
        part = host[start:start + s.numel()].reshape(tuple(s.shape))
        out.append(part > 0.5 if s.dtype == torch.bool else part)
        start += s.numel()
    return out


@torch.no_grad()
def rollout_trajectory(env: Env, num_steps: int,
                       generator: torch.Generator, actor=None,
                       normalizer_cfg=None, scaler_cfg=None,
                       sample: bool = False) -> Trajectory:
    """Run ``num_steps`` of the env under scripted or policy actions.

    Without ``actor`` the actions come from ``env.sample_actions`` (the
    scripted sampler, which must exist).  With ``actor`` (an ``Actor`` on
    the env's device) they are the policy's mean, or samples where
    ``sample``; the policy sees the normalized observations, carried from
    step to step.  ``generator`` (on the env's device) seeds the env's
    init and resets and the action samples."""
    if actor is None and env.sample_actions is None:
        raise ValueError("env has no scripted sampler and no actor was given")
    if actor is None:
        # The reference's scripted samplers are generators that yield
        # exactly max_step tensors and raise StopIteration past that
        # (reference utils.py:428-448); the overrun is rejected up front.
        bound = getattr(env.sample_actions, "max_step", None)
        if bound is not None and num_steps > bound:
            raise StopIteration(f"scripted sampler provides {bound} steps, "
                                f"{num_steps} requested")
    else:
        from marlnav_tpu_torch.models import DiagGaussian
        from marlnav_tpu_torch.utils.transforms import (make_action_scaler,
                                                        make_obs_normalizer)

        normalize = make_obs_normalizer(normalizer_cfg, env.device)
        scale_up = make_action_scaler(scaler_cfg, env.device)
        p, a = env.params.num_parallel, env.params.num_agents

    state = env.init(generator)
    obs = normalize(env.observations(state)) if actor is not None else None
    frames = [[] for _ in range(6 + len(_OBS_FIELDS))]
    for step in range(num_steps):
        if actor is None:
            actions = env.sample_actions(step)
        else:
            mean, var = actor(obs)
            raw = DiagGaussian(mean, var).sample(generator) if sample \
                else mean
            actions = scale_up(raw.reshape(p, a, 2))
        state, out = env.step(state, actions)
        if actor is not None:
            obs = normalize(out.obs)
        for f, x in zip(frames, (
                state.states, state.obstacles, state.target, out.rewards,
                out.terminated, out.truncated,
                *(getattr(out.obs, k) for k in _OBS_FIELDS))):
            f.append(x)
    (states, obstacles, target, rewards, terminated, truncated,
     *obs_fields) = _fetch(frames)
    return Trajectory(states, obstacles, target, Observations(*obs_fields),
                      rewards, terminated, truncated)
