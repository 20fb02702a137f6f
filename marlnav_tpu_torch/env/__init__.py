"""Batched navigation environment."""

from marlnav_tpu_torch.env.env import Env, make_env
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats, Observations

__all__ = ["Env", "EnvState", "EpisodeStats", "Observations", "make_env"]
