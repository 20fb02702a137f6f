"""Actor / critic networks and the Gaussian policy distribution."""

from marlnav_tpu_torch.models.distributions import DiagGaussian
from marlnav_tpu_torch.models.networks import (
    Actor,
    Critic,
    flat_params,
    from_jax_params,
    load_flat_params,
    to_jax_params,
)

__all__ = [
    "Actor",
    "Critic",
    "DiagGaussian",
    "flat_params",
    "from_jax_params",
    "load_flat_params",
    "to_jax_params",
]
