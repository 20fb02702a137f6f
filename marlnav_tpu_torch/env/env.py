"""The batched navigation environment as ``init`` / ``step`` functions.

Port of ``marlnav_tpu/env/env.py``.  Step semantics keep the reference's
exact ordering (reference environment.py:92-107):

  move -> step_num += 1 -> truncated -> observations -> rewards &
  terminations (from the *pre-reinit* state) -> reinit mask = terminated |
  truncated -> fresh draw for all P envs, mask-blended -> observations
  recomputed post-reinit and returned.

The fresh draw consumes the ``torch.Generator`` carried in
``EnvState.generator``.  ``step`` returns a new ``EnvState``; it writes
into no tensor it was given.  ``sample_actions`` is the scripted sampler
of ``sampler_cfg`` (env/samplers.py), or None where a policy acts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from marlnav_tpu_torch.config import EnvParams, MockInitConfig
from marlnav_tpu_torch.env import geometry
from marlnav_tpu_torch.env.dynamics import move_agents
from marlnav_tpu_torch.env.initializers import make_initializer
from marlnav_tpu_torch.env.reward import rewards_and_terminations
from marlnav_tpu_torch.env.samplers import SamplerFn, make_action_sampler
from marlnav_tpu_torch.env.types import (EnvState, EpisodeStats, Observations,
                                         StepOutput)
from marlnav_tpu_torch.utils.seeding import resolve_device


@dataclasses.dataclass
class Env:
    """Bundle of environment functions over a fixed configuration."""

    params: EnvParams
    device: torch.device
    init: Callable[[torch.Generator], EnvState]
    step: Callable[[EnvState, torch.Tensor], tuple]
    observations: Callable[[EnvState], Observations]
    sample_actions: Optional[SamplerFn] = None


def compute_observations(states, obstacles, target, params: EnvParams,
                         others_idx) -> Observations:
    """One broadcasted pairwise-geometry pass over (P, A, K); angles (not
    distances) are zeroed below ``cap_distance``
    (reference environment.py:139-182)."""
    positions = states[:, :, :2]
    headings = states[:, :, 2:4]

    tar_ang, tar_dist = geometry.angles_and_distances(positions, headings,
                                                      target)
    obs_ang, obs_dist = geometry.angles_and_distances(positions, headings,
                                                      obstacles)
    others_pos = states[:, others_idx, :2]  # (P, A, A-1, 2)
    oth_ang, oth_dist = geometry.angles_and_distances(positions, headings,
                                                      others_pos)
    cap = params.cap_distance
    return Observations(
        target_angle=torch.where(tar_dist < cap, 0.0, tar_ang),
        target_distance=tar_dist,
        obstacles_angles=torch.where(obs_dist < cap, 0.0, obs_ang),
        obstacles_distances=obs_dist,
        others_angles=torch.where(oth_dist < cap, 0.0, oth_ang),
        others_distances=oth_dist,
    )


def make_env(params: EnvParams, init_cfg, device="cuda", *,
             sampler_cfg=None) -> Env:
    """Build the environment function bundle on ``device``; ``init_cfg``
    selects the reset distribution (triangle or mock), ``sampler_cfg`` the
    scripted actions of ``Env.sample_actions`` (None: a policy acts).
    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``"cpu"`` to run on the CPU."""
    device = resolve_device(device)
    init_fn = make_initializer(init_cfg, device)
    others_idx = geometry.others_indices(params.num_agents, device)
    p = params.num_parallel
    # Mock initializers need the reference's aliasing-bug emulation (see
    # EnvState in types.py).
    mock_aliasing = isinstance(init_cfg, MockInitConfig)

    def init(generator: torch.Generator) -> EnvState:
        states, obstacles, target = init_fn(generator)
        if params.staggered_resets:
            # Uniform initial phases decorrelate episode boundaries across
            # the batch (EnvParams.staggered_resets).
            step_num = torch.randint(0, params.episode_len, (p,),
                                     generator=generator, device=device,
                                     dtype=torch.int32)
        else:
            step_num = torch.zeros((p,), dtype=torch.int32, device=device)
        return EnvState(
            states=states,
            obstacles=obstacles,
            target=target,
            step_num=step_num,
            terminates=torch.zeros((p,), dtype=torch.bool, device=device),
            stats=EpisodeStats.zeros(device),
            generator=generator,
            reset_states=states if mock_aliasing else None,
            virgin=True if mock_aliasing else None,
        )

    def observations(state: EnvState) -> Observations:
        return compute_observations(state.states, state.obstacles,
                                    state.target, params, others_idx)

    def step(state: EnvState, actions: torch.Tensor):
        """One lockstep transition for all P envs.  ``actions`` (P, A, 2)
        in physical scale.  Returns ``(new_state, StepOutput)``."""
        states = move_agents(state.states, actions, params)
        step_num = state.step_num + 1
        truncated = step_num > params.episode_len - 1

        obs = compute_observations(states, state.obstacles, state.target,
                                   params, others_idx)
        prev_max_dist = None
        if params.group_soft_factor:
            # Pre-move max-over-agents target distance (env/reward.py).
            delta = state.states[:, :, :2] - state.target
            prev_max_dist = torch.amax(
                torch.sqrt(torch.sum(delta * delta, dim=2)), dim=1)
        rew = rewards_and_terminations(obs, state.terminates, params,
                                       prev_max_dist)

        stats = EpisodeStats(
            num_trunc=state.stats.num_trunc
            + torch.sum(truncated).to(torch.int32),
            num_col=state.stats.num_col + rew.col_count,
            num_tar=state.stats.num_tar + rew.tar_count,
        )

        # Auto-reset: fresh draw for every env, blended in where finished
        # (reference environment.py:76-90, 102-105).
        finished = truncated | rew.terminated
        new_states, new_obstacles, new_target = init_fn(state.generator)
        reset_states, virgin = state.reset_states, state.virgin
        if mock_aliasing:
            # Reference aliasing bug: the reset pool becomes the once-moved
            # states (see EnvState).
            if virgin:
                reset_states = states
            virgin = False
            new_states = reset_states
        m3 = finished[:, None, None]
        states = torch.where(m3, new_states, states)
        obstacles = torch.where(m3, new_obstacles, state.obstacles)
        target = torch.where(m3, new_target, state.target)
        step_num = torch.where(finished, 0, step_num)

        new_state = EnvState(
            states=states,
            obstacles=obstacles,
            target=target,
            step_num=step_num,
            terminates=rew.new_latch,
            stats=stats,
            generator=state.generator,
            reset_states=reset_states,
            virgin=virgin,
        )
        # Observations recomputed from the post-reinit state — finished
        # envs report their fresh episode's first view
        # (reference environment.py:105).
        out_obs = compute_observations(states, obstacles, target, params,
                                       others_idx)
        return new_state, StepOutput(out_obs, rew.rewards, rew.terminated,
                                     truncated)

    return Env(params=params, device=device, init=init, step=step,
               observations=observations,
               sample_actions=make_action_sampler(sampler_cfg, device))
