"""Returns and advantages of a rollout, in plain PyTorch loops.

The zero-at-done discounted returns, z-normalized over the whole buffer
with the unbiased (N - 1) standard deviation, and bootstrapped
GAE(lambda), each a reverse loop over the T steps of (T, P) tensors.
"""

from __future__ import annotations

import torch


def discounted_returns(rewards, done, gamma: float,
                       dtype=torch.float32) -> torch.Tensor:
    rewards = rewards.to(dtype)
    rets = torch.empty_like(rewards)
    curr = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        curr = torch.where(done[t], 0.0, rewards[t] + gamma * curr)
        rets[t] = curr
    return rets


def normalized_returns(rewards, done, gamma: float, f64: bool):
    """``(normalized returns (T, P) float32, mean of the unnormalized
    returns)``, accumulated in float64 where ``f64``."""
    rets = discounted_returns(rewards, done, gamma,
                              torch.float64 if f64 else torch.float32)
    mean = torch.mean(rets)
    std = torch.sqrt(torch.sum((rets - mean) ** 2) / (rets.numel() - 1))
    return ((rets - mean) / (std + 1e-12)).to(torch.float32), mean


def gae_advantages(rewards, done, values, last_value, gamma: float,
                   lam: float) -> torch.Tensor:
    adv = torch.empty_like(rewards)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        not_done = 1.0 - done[t].to(rewards.dtype)
        delta = rewards[t] + gamma * next_value * not_done - values[t]
        gae = delta + gamma * lam * not_done * gae
        adv[t] = gae
        next_value = values[t]
    return adv
