"""Initial-state distributions (the env's pluggable reset backends).

Port of ``marlnav_tpu/env/initializers.py`` (reference utils.py:310-416):
each initializer is a function ``sample(generator) -> (states, obstacles,
target)``.  The same function serves initial construction and the per-step
auto-reset draw, which draws a fresh population for *all* P envs and
mask-blends it in (reference environment.py:76-90).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from marlnav_tpu_torch.config import MockInitConfig, TriangleInitConfig
from marlnav_tpu_torch.env.geometry import rotate

InitFn = Callable[[torch.Generator],
                  Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def make_mock_initializer(cfg: MockInitConfig, device) -> InitFn:
    """Constant initial state (reference utils.py:310-319).  Consumes no
    random numbers — the basis of the golden parity tests."""
    states = torch.tensor(cfg.states, dtype=torch.float32, device=device)
    obstacles = torch.tensor(cfg.obstacles, dtype=torch.float32, device=device)
    target = torch.tensor(cfg.target, dtype=torch.float32, device=device)

    def sample(generator: torch.Generator):
        del generator
        return states, obstacles, target

    return sample


def triangle_base_positions(cfg: TriangleInitConfig):
    """The three agents' start positions: an equilateral triangle with side
    ``ags_dist`` around the centre point (reference utils.py:349-368)."""
    pos_const = 0.5 * cfg.ags_dist
    r3 = math.sqrt(3.0)
    xs = tuple(cfg.ags_cent_x + pos_const * v for v in (-1.0 / r3, 2.0 / r3,
                                                        -1.0 / r3))
    ys = tuple(cfg.ags_cent_y + pos_const * v for v in (1.0, 0.0, -1.0))
    return xs, ys


def make_triangle_initializer(cfg: TriangleInitConfig, device) -> InitFn:
    """Three agents in an equilateral triangle facing +x, target disk to the
    right, obstacles uniform in a rectangle (reference utils.py:322-408).

    With ``noisy_ags`` the agent positions get Gaussian noise (std
    ``ags_dist * sqrt(ags_std)`` per coordinate: the reference's
    MultivariateNormal takes ags_std as the covariance diagonal) and
    headings a uniform rotation in ``[-angle_range/2, angle_range/2]``
    (reference utils.py:370-388).
    """
    p, num_obs = cfg.num_parallel, cfg.num_obstacles
    f32 = dict(dtype=torch.float32, device=device)
    xs, ys = triangle_base_positions(cfg)
    base_pos = torch.tensor(list(zip(xs, ys)), **f32).expand(p, 3, 2)
    base_dir = torch.tensor([1.0, 0.0], **f32).expand(p, 3, 2)
    speeds = torch.full((p, 3, 1), cfg.init_speed, **f32)
    target = torch.tensor([cfg.tar_pos_x, cfg.tar_pos_y], **f32).expand(
        p, 1, 2).contiguous()

    ox_range = cfg.obst_max_x - cfg.obst_min_x
    oy_range = cfg.obst_max_y - cfg.obst_min_y
    ox_mean = 0.5 * (cfg.obst_min_x + cfg.obst_max_x)
    oy_mean = 0.5 * (cfg.obst_min_y + cfg.obst_max_y)
    pos_std = cfg.ags_dist * math.sqrt(cfg.ags_std)

    def sample(generator: torch.Generator):
        # Obstacles uniform over [min, max] x [min, max]
        # (reference utils.py:390-398).
        u = torch.rand((p, num_obs, 2), generator=generator, **f32) - 0.5
        obstacles = torch.stack(
            [u[..., 0] * ox_range + ox_mean, u[..., 1] * oy_range + oy_mean],
            dim=-1)
        if cfg.noisy_ags:
            pos_noise = pos_std * torch.randn((p, 3, 2), generator=generator,
                                              **f32)
            angles = cfg.angle_range * (
                torch.rand((p, 3), generator=generator, **f32) - 0.5)
            positions = base_pos + pos_noise
            directions = rotate(base_dir, angles)
        else:
            positions, directions = base_pos, base_dir
        states = torch.cat([positions, directions, speeds], dim=2)
        return states, obstacles, target

    return sample


def make_initializer(cfg, device) -> InitFn:
    """Factory dispatch (reference utils.py:411-416)."""
    if isinstance(cfg, MockInitConfig):
        return make_mock_initializer(cfg, device)
    if isinstance(cfg, TriangleInitConfig):
        return make_triangle_initializer(cfg, device)
    raise TypeError(f"unknown initializer config: {type(cfg).__name__}")
