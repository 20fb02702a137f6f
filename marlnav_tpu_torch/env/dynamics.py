"""Agent dynamics: heading rotation + clamped speed integrator.

Port of ``marlnav_tpu/env/dynamics.py`` (reference environment.py:113-137),
same op order: steering angle clamped to [-pi, pi], heading rotated,
acceleration clamped to [min_accel, max_accel], speed = clamp(speed +
accel, [min_speed, max_speed]), position += new_heading * new_speed.
"""

from __future__ import annotations

import math

import torch

from marlnav_tpu_torch.config import EnvParams
from marlnav_tpu_torch.env.geometry import rotate


def move_agents(states: torch.Tensor, actions: torch.Tensor,
                params: EnvParams) -> torch.Tensor:
    """Advance the (P, A, 5) state by one step of physical actions
    ``actions`` (P, A, 2): [steering angle (rad), acceleration]."""
    angles = torch.clamp(actions[:, :, 0], -math.pi, math.pi)
    directions = rotate(states[:, :, 2:4], angles)
    accel = torch.clamp(actions[:, :, 1:2], params.min_accel, params.max_accel)
    speeds = torch.clamp(states[:, :, 4:5] + accel, params.min_speed,
                         params.max_speed)
    positions = states[:, :, :2] + directions * speeds
    return torch.cat([positions, directions, speeds], dim=2)
