"""Scripted action samplers (deterministic test fixtures).

Port of ``marlnav_tpu/env/samplers.py``.  The reference implements these as
stateful Python generators (reference utils.py:419-497); here, as in the
JAX package, each sampler is a function of the step index, ``actions(step)
-> (P, A, 2)``, a tensor on the env's device built once, so a rollout loop
reads no device value to pick a step's actions.  Actions are in physical
scale (the reward-check harness feeds them straight to the env, reference
utils.py:595-597).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from marlnav_tpu_torch.config import ConstantSamplerConfig, MockSamplerConfig

SamplerFn = Callable[[int], torch.Tensor]


def _actions(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def make_constant_sampler(cfg: ConstantSamplerConfig,
                          device="cpu") -> SamplerFn:
    """Every agent plays [angle=0, accel=1] forever (reference
    utils.py:477-485).  The env clamps the acceleration to ``max_accel``,
    so agents run straight and accelerate to max speed."""
    actions = _actions([0.0, 1.0], device).expand(
        cfg.num_parallel, cfg.num_agents, 2).contiguous()

    def sample(step: int) -> torch.Tensor:
        del step
        return actions

    return sample


def make_mock_sampler(cfg: MockSamplerConfig, device="cpu") -> SamplerFn:
    """The two deterministic scripted-action scenarios.

    ``num=0`` (reference utils.py:97-105, 423-431): constant per-agent
    actions, straight-line runs, one agent slammed to min speed by a -100
    deceleration.

    ``num=1`` (reference utils.py:107-115, 432-448): step 0 applies special
    half-actions (turn-in maneuvers), every later step constant turn rates,
    which give circular orbits (radius-300 orbits at 1.8 degrees a step).
    """

    def bounded(sample: SamplerFn) -> SamplerFn:
        """The reference's generator exhaustion: its samplers yield exactly
        ``max_step`` tensors, then ``next()`` raises StopIteration
        (reference utils.py:428-448).  An int step at or past the bound
        raises; the bound is exported as ``sample.max_step``, which
        ``diagnostics.trajectory`` checks before a rollout."""
        if cfg.max_step is None:
            return sample

        def guarded(step):
            if isinstance(step, int) and step >= cfg.max_step:
                raise StopIteration(
                    f"mock sampler exhausted after {cfg.max_step} steps")
            return sample(step)

        guarded.max_step = cfg.max_step
        return guarded

    if cfg.num == 0:
        actions = _actions([[[0.0, 5.0], [0.0, 0.1], [0.0, -0.05]],
                            [[0.0, 5.0], [0.0, 0.1], [0.0, -100.0]]], device)

        def sample(step: int) -> torch.Tensor:
            del step
            return actions

        return bounded(sample)

    if cfg.num == 1:
        turn = math.radians(1.8)
        first = _actions(
            [[[-math.pi / 6, 0.0], [0.0, 0.0], [math.pi / 6, 0.0]],
             [[-0.5 * turn, 0.0], [0.0, 0.0], [0.5 * turn, 0.0]]], device)
        rest = _actions([[[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                         [[-turn, 0.0], [0.0, 0.0], [turn, 0.0]]], device)

        def sample(step: int) -> torch.Tensor:
            return first if step == 0 else rest

        return bounded(sample)

    raise ValueError(f"unknown mock sampler {cfg.num}")


def make_action_sampler(cfg, device="cpu") -> Optional[SamplerFn]:
    """Factory dispatch (reference utils.py:488-497).  A ``None`` config
    means actions come from a policy instead."""
    if cfg is None:
        return None
    if isinstance(cfg, ConstantSamplerConfig):
        return make_constant_sampler(cfg, device)
    if isinstance(cfg, MockSamplerConfig):
        return make_mock_sampler(cfg, device)
    raise TypeError(f"unknown sampler config: {type(cfg).__name__}")
