"""Diagonal-covariance Gaussian policy distribution.

Port of ``marlnav_tpu/models/distributions.py``.  The reference wraps the
actor heads in ``MultivariateNormal(mu, diag(softplus(...)))``
(reference models.py:30-36): the softplus head is the *covariance* diagonal
(the variance).  ``sample`` / ``log_prob`` / ``entropy`` in closed form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class DiagGaussian:
    """Batch of independent Gaussians: mean (..., K); var (..., K) — the
    covariance diagonal."""

    mean: torch.Tensor
    var: torch.Tensor

    def sample(self, generator: torch.Generator,
               shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """A sample of every Gaussian.  ``shard = (rows, first)``: these
        Gaussians are rows ``first ..`` of ``rows`` along the leading axis
        (a rank's envs under a data-parallel mesh); the noise of all
        ``rows`` is drawn, as a run without a mesh draws it, and this
        shard's rows of it kept."""
        shape = self.mean.shape
        if shard is not None:
            shape = (shard[0],) + tuple(shape[1:])
        eps = torch.randn(shape, generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        if shard is not None:
            eps = eps[shard[1]:shard[1] + self.mean.shape[0]]
        return self.mean + torch.sqrt(self.var) * eps

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """(...,) — MultivariateNormal.log_prob with diagonal covariance."""
        k = self.mean.shape[-1]
        diff = x - self.mean
        maha = torch.sum(diff * diff / self.var, dim=-1)
        logdet = torch.sum(torch.log(self.var), dim=-1)
        return -0.5 * (k * _LOG_2PI + logdet + maha)

    def entropy(self) -> torch.Tensor:
        """(...,) — 0.5*k*(1 + log 2pi) + 0.5*log det(cov)."""
        k = self.mean.shape[-1]
        logdet = torch.sum(torch.log(self.var), dim=-1)
        return 0.5 * k * (1.0 + _LOG_2PI) + 0.5 * logdet
