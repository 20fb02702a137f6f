"""Vectorized pairwise geometry: distances and signed view angles.

Port of ``marlnav_tpu/env/geometry.py``; semantics are op-for-op those of
the reference (reference environment.py:271-286):

* distances: Euclidean norm of position differences;
* angles: normalize the offset with an eps-guarded norm (eps=1e-12), dot
  with the unit heading clamped to ``[-1+1e-8, 1-1e-8]``, ``arccos``, and
  sign = -1 where the x-component of the orthogonal part of the offset is
  > 0, else +1.  When the heading is exactly (±1, 0) the orthogonal
  x-component is exactly 0 and the sign is always +1 (the reference's
  degenerate branch, kept).
"""

from __future__ import annotations

import torch

_NORMALIZE_EPS = 1e-12  # torch F.normalize default
_ACOS_CLAMP = 1e-8  # reference environment.py:281


def angles_and_distances(positions: torch.Tensor, headings: torch.Tensor,
                         points: torch.Tensor):
    """Signed view angles and distances from each agent to each point.

    positions, headings (P, A, 2); points (P, K, 2) shared by all agents or
    (P, A, K, 2) per agent.  Returns ``(angles, distances)``, each (P, A, K).
    """
    if points.dim() == 3:
        points = points[:, None, :, :]  # (P, 1, K, 2) broadcasts over A

    diff = points - positions[:, :, None, :]  # (P, A, K, 2)
    distances = torch.sqrt(torch.sum(diff * diff, dim=-1))

    unit = diff / torch.clamp_min(distances, _NORMALIZE_EPS)[..., None]
    dot = torch.sum(headings[:, :, None, :] * unit, dim=-1)
    dot = torch.clamp(dot, -1.0 + _ACOS_CLAMP, 1.0 - _ACOS_CLAMP)

    # Orthogonal component of the unit offset w.r.t. the heading; only its
    # x-coordinate decides the sign (reference environment.py:282-284).
    orth_x = unit[..., 0] - dot * headings[:, :, None, 0]
    signs = torch.where(orth_x > 0.0, -1.0, 1.0)
    return signs * torch.arccos(dot), distances


def others_indices(num_agents: int, device=None) -> torch.Tensor:
    """(A, A-1) int64 — for each agent, the indices of the other agents
    (reference environment.py:22-24)."""
    idx = [[i for i in range(num_agents) if i != j] for j in range(num_agents)]
    return torch.tensor(idx, dtype=torch.int64, device=device)


def rotate(directions: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate 2-D vectors by per-element angles:
    ``[[cos, -sin], [sin, cos]] @ [dx, dy]``.
    directions (..., 2), angles (...,) -> (..., 2)."""
    c, s = torch.cos(angles), torch.sin(angles)
    dx, dy = directions[..., 0], directions[..., 1]
    return torch.stack([c * dx - s * dy, s * dx + c * dy], dim=-1)
