"""Environment state and observation containers.

Dataclass counterparts of ``marlnav_tpu/env/types.py``'s NamedTuples.
Shapes, dtypes and field order are the same, so tests compare the two
packages field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Observations:
    """Per-agent egocentric observations.

    Field order is the concatenation order used by the obs normalizer and
    its bounds table (reference utils.py:13-15, 117-140, 530-532).

    Shapes (P = parallel envs, A = agents, O = obstacles):
      target_angle        (P, A, 1)
      target_distance     (P, A, 1)
      obstacles_angles    (P, A, O)
      obstacles_distances (P, A, O)
      others_angles       (P, A, A-1)
      others_distances    (P, A, A-1)
    """

    target_angle: torch.Tensor
    target_distance: torch.Tensor
    obstacles_angles: torch.Tensor
    obstacles_distances: torch.Tensor
    others_angles: torch.Tensor
    others_distances: torch.Tensor

    def fields(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def concat(self) -> torch.Tensor:
        """(P, A, 2 + 2O + 2(A-1)) flat observation tensor."""
        return torch.cat(self.fields(), dim=2)


@dataclasses.dataclass
class EpisodeStats:
    """Episode-ending counters, kept on the device and fetched once per
    rollout (the reference syncs them every step, environment.py:98)."""

    num_trunc: torch.Tensor  # () int32 — truncations seen
    num_col: torch.Tensor  # () int32 — collision terminations seen
    num_tar: torch.Tensor  # () int32 — env-steps with all agents in target

    @staticmethod
    def zeros(device) -> "EpisodeStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return EpisodeStats(z, z.clone(), z.clone())


@dataclasses.dataclass
class EnvState:
    """Complete environment state.

    states     (P, A, 5) float32 — [x, y, dir_x, dir_y, speed]
    obstacles  (P, O, 2) float32
    target     (P, 1, 2) float32
    step_num   (P,)      int32   — per-env step counter
    terminates (P,)      bool    — delayed target-reach latch
                                   (reference environment.py:216-221)
    stats      EpisodeStats
    generator  the torch.Generator the per-step auto-reset draws consume

    ``reset_states`` / ``virgin`` emulate a reference aliasing bug for mock
    initializers only (see marlnav_tpu/env/types.py EnvState): the first
    step's in-place move corrupts the mock initializer's stored states, so
    every later auto-reset restores the once-moved states.  Both are None
    for the triangle initializer.
    """

    states: torch.Tensor
    obstacles: torch.Tensor
    target: torch.Tensor
    step_num: torch.Tensor
    terminates: torch.Tensor
    stats: EpisodeStats
    generator: torch.Generator
    reset_states: Optional[torch.Tensor] = None
    virgin: Optional[bool] = None


@dataclasses.dataclass
class StepOutput:
    """What ``step`` returns alongside the new state
    (reference environment.py:107)."""

    obs: Observations
    rewards: torch.Tensor  # (P,) float32
    terminated: torch.Tensor  # (P,) bool
    truncated: torch.Tensor  # (P,) bool
