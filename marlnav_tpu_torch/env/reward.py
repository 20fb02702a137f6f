"""Reward components, collision termination and the delayed target latch.

Port of ``marlnav_tpu/env/reward.py`` (reference environment.py:184-269):
the group target bonus uses min-over-agents membership broadcast back to
every agent; a collision terminates immediately; group target-reach sets a
*delayed* terminate latch; the summation order of the components is kept.
``group_soft_factor`` adds the potential-based group-convergence shaping
(off by default; see the JAX module for its rationale).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from marlnav_tpu_torch.config import EnvParams
from marlnav_tpu_torch.env.types import Observations


@dataclasses.dataclass
class RewardOutput:
    rewards: torch.Tensor  # (P,) float32 — mean over agents
    terminated: torch.Tensor  # (P,) bool
    new_latch: torch.Tensor  # (P,) bool — updated delayed-terminate latch
    tar_count: torch.Tensor  # () int32 — envs with all agents in target
    col_count: torch.Tensor  # () int32 — envs with >= 1 collision


def _in_area(distances: torch.Tensor, radius: float) -> torch.Tensor:
    """1.0 where any observed object is within ``radius``
    (reference environment.py:236-241).  (P, A, K) -> (P, A)."""
    return torch.amax((distances < radius).float(), dim=2)


def _distance_reward(distances: torch.Tensor, params: EnvParams):
    """Fraction (capped) of other agents within the proper distance band
    (reference environment.py:243-251)."""
    inside = ((params.agents_min_d < distances).float()
              * (distances < params.agents_max_d).float())
    capped = torch.clamp_max(torch.sum(inside, dim=2), params.max_at_prop_d)
    return capped / params.max_at_prop_d


def _bond_reward(distances: torch.Tensor, params: EnvParams):
    """Cauchy bump peaked at the ideal bond distance
    (reference environment.py:264-269)."""
    scaled = (distances - params.ideal_dist) / params.bond_sharpness
    return torch.mean(1.0 / (1.0 + scaled * scaled), dim=2)


def rewards_and_terminations(
    obs: Observations, latch: torch.Tensor, params: EnvParams,
    prev_max_dist: Optional[torch.Tensor] = None,
) -> RewardOutput:
    """(P,) rewards and termination flags from observations.

    ``latch`` is the (P,) bool delayed target-reach latch; ``prev_max_dist``
    (P,) the PRE-move max-over-agents target distance, required iff
    ``params.group_soft_factor`` is set.
    """
    obstacle_risks = _in_area(obs.obstacles_distances, params.ob_risk_dist)
    agent_risks = _in_area(obs.others_distances, params.ag_risk_dist)
    obstacle_colls = _in_area(obs.obstacles_distances, params.ob_coll_dist)
    agent_colls = _in_area(obs.others_distances, params.ag_coll_dist)

    in_target = (obs.target_distance < params.target_radius).float()
    distance_scores = _distance_reward(obs.others_distances, params)
    heading_scores = (torch.abs(obs.target_angle[:, :, 0])
                      < params.max_angle_diff).float()
    soft_score = -obs.target_distance[:, :, 0] / params.init_dist
    bond_score = _bond_reward(obs.others_distances, params)

    risks = torch.clamp_max(obstacle_risks + agent_risks, 1.0)
    collisions = torch.clamp_max(obstacle_colls + agent_colls, 1.0)
    atleast_1_coll = torch.amax(collisions, dim=1)  # (P,)
    all_in_target = torch.amin(in_target, dim=1)  # (P, 1)

    tar_count = torch.sum(all_in_target).to(torch.int32)
    col_count = torch.sum(atleast_1_coll).to(torch.int32)

    terminated = (atleast_1_coll > 0) | latch
    to_terminate = all_in_target[:, 0] > 0
    # Only previously-False entries latch, so reinit fires exactly once per
    # target reach (reference environment.py:218-221).
    new_latch = (~latch) & to_terminate

    reward = (
        params.target_factor * all_in_target  # broadcasts (P,1) over agents
        + params.heading_factor * heading_scores
        + params.distance_factor * distance_scores
        + params.soft_factor * soft_score
        + params.bond_factor * bond_score
        - params.risk_factor * risks
    )
    if params.group_soft_factor:
        if prev_max_dist is None:
            raise ValueError(
                "group_soft_factor requires prev_max_dist: the potential-"
                "based shaping needs the pre-move max target distance")
        new_max = torch.amax(obs.target_distance[:, :, 0], dim=1,
                             keepdim=True)
        reward = reward + (params.group_soft_factor / params.init_dist) * (
            prev_max_dist[:, None] - new_max)
    return RewardOutput(
        rewards=torch.mean(reward, dim=1),
        terminated=terminated,
        new_latch=new_latch,
        tar_count=tar_count,
        col_count=col_count,
    )
