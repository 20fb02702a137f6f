"""Observation normalization and action scaling.

Port of ``marlnav_tpu/utils/transforms.py``: these affine transforms live
outside the env, as in the reference — the env consumes physical-scale
actions and emits physical-scale observations; the policy sees [-1, 1] on
both sides (reference utils.py:519-547).
"""

from __future__ import annotations

from typing import Callable

import torch

from marlnav_tpu_torch.config import NormalizerConfig, ScalerConfig
from marlnav_tpu_torch.env.types import Observations


def make_obs_normalizer(cfg: NormalizerConfig, device="cpu"
                        ) -> Callable[[Observations], torch.Tensor]:
    """Concatenate the observations and map each feature from its
    [min, max] bounds to [-1, 1] (reference utils.py:519-532)."""
    min_obs, max_obs = (torch.tensor(b, dtype=torch.float32, device=device)
                        for b in cfg.bounds())
    mean = 0.5 * (min_obs + max_obs)
    scale = 0.5 * (max_obs - min_obs)

    def normalize(obs: Observations) -> torch.Tensor:
        return (obs.concat() - mean) / scale  # (P, A, obs_size)

    return normalize


def make_action_scaler(cfg: ScalerConfig, device="cpu"
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Map network outputs in [-1, 1] to physical [angle, accel] ranges
    (reference utils.py:535-547)."""
    min_action, max_action = (torch.tensor(b, dtype=torch.float32,
                                           device=device)
                              for b in cfg.bounds())
    mean = 0.5 * (min_action + max_action)
    scale = 0.5 * (max_action - min_action)

    def scale_up(actions: torch.Tensor) -> torch.Tensor:
        return scale * actions + mean

    return scale_up
