"""Headline benchmark: random-policy lockstep env stepping throughput.

    python -m marlnav_tpu_torch.bench [--plain] [--device cpu]
                                      [--num-envs N] [--num-steps T]

The port's counterpart of the JAX package's ``bench.py``: 3 agents, 3
obstacles, 16384 parallel envs, 500-step rollouts with auto-reset on
terminal, a random policy (the ``Actor`` at hidden 50, drawn from seed 0).
Two routes:

* the fused rollout kernel (``ops/fused_rollout.py``): the whole rollout
  as one CUDA kernel, the headline;
* with ``--plain``, the plain PyTorch step loop the trainer's plain collect
  runs: the actor, a ``DiagGaussian`` sample and ``env.step`` a step.

Each route runs one rollout (on the card: the kernel's build and first
launch), then ``TIMED_CALLS`` rollouts with fresh seeds, each reducing its
rewards to a mean on the device; the timing closes with
``torch.cuda.synchronize()``.  Prints ONE JSON line on stdout,

    {"metric": "env_steps_per_s", "value": N, "unit": "steps/s"}

(the faster route's rate), and the per-route detail on stderr.  It runs on
the card and raises where CUDA is absent; ``--device cpu`` runs the routes
on the CPU (the fused one through the kernel's plain version) at the size
given by ``--num-envs`` and ``--num-steps``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, DiagGaussian
from marlnav_tpu_torch.ops.fused_rollout import (env_state_to_rows,
                                                 make_fused_rollout)
from marlnav_tpu_torch.utils.seeding import make_generator, resolve_device
from marlnav_tpu_torch.utils.transforms import (make_action_scaler,
                                                make_obs_normalizer)

NUM_AGENTS = 3
HEADLINE = (16384, 500)  # (num_envs, steps per rollout)
TIMED_CALLS = 5


def _configs(num_envs: int):
    return (EnvParams(num_parallel=num_envs, num_agents=NUM_AGENTS),
            TriangleInitConfig(num_parallel=num_envs, num_obstacles=3))


def _actor(obs_size: int, device) -> Actor:
    return Actor(obs_size, 50, generator=torch.Generator().manual_seed(0)
                 ).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_rollouts(name, fn, state, num_envs, num_steps, device):
    """One untimed rollout, then ``TIMED_CALLS`` timed ones with seeds
    1..TIMED_CALLS; returns (env-steps/s, the last rollout's mean
    reward)."""
    t0 = time.perf_counter()
    state, mean_rew = fn(state, 0)
    _sync(device)
    print(f"{name}: first run (with any kernel build) "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for i in range(TIMED_CALLS):
        state, mean_rew = fn(state, 1 + i)
    _sync(device)
    dt = time.perf_counter() - t0
    steps_per_s = num_envs * num_steps * TIMED_CALLS / dt
    print(f"{name}: {TIMED_CALLS}x{num_steps}-step rollouts of {num_envs} "
          f"envs in {dt:.3f}s -> {steps_per_s / 1e6:.2f}M steps/s (mean "
          f"reward {float(mean_rew):.1f})", file=sys.stderr)
    return steps_per_s, float(mean_rew)


def measure_fused(num_envs: int, num_steps: int, device):
    """The fused rollout kernel (its plain version on the CPU)."""
    ep, ic = _configs(num_envs)
    rows = env_state_to_rows(make_env(ep, ic, device).init(
        make_generator(0, device)))
    actor = _actor(ep.obs_size, device)
    roll = make_fused_rollout(ep, ic, NormalizerConfig(num_agents=NUM_AGENTS),
                              ScalerConfig(), num_steps, device=device)

    def rollout(rows, seed):
        rows, rewards = roll(rows, actor, seed)
        return rows, torch.mean(rewards)

    return _time_rollouts("fused-rollout", rollout, rows, num_envs,
                          num_steps, device)


def measure_plain(num_envs: int, num_steps: int, device):
    """The plain PyTorch step loop (the trainer's plain collect's shape:
    the policy reads the carried step-output observations)."""
    ep, ic = _configs(num_envs)
    env = make_env(ep, ic, device)
    normalize = make_obs_normalizer(NormalizerConfig(num_agents=NUM_AGENTS),
                                    device)
    scale_up = make_action_scaler(ScalerConfig(), device)
    state = env.init(make_generator(0, device))
    actor = _actor(ep.obs_size, device)

    @torch.no_grad()
    def rollout(state, seed):
        generator = make_generator(seed, device)
        obs = normalize(env.observations(state))
        rewards = []
        for _ in range(num_steps):
            mean, var = actor(obs)
            actions = DiagGaussian(mean, var).sample(generator)
            state, out = env.step(state, scale_up(
                actions.reshape(num_envs, NUM_AGENTS, 2)))
            rewards.append(out.rewards)
            obs = normalize(out.obs)
        return state, torch.mean(torch.stack(rewards))

    return _time_rollouts("plain-loop", rollout, state, num_envs, num_steps,
                          device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="marlnav_tpu_torch.bench",
        description="env-steps/s of the random-policy rollout")
    parser.add_argument("--plain", action="store_true",
                        help="also time the plain PyTorch step loop")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises when CUDA "
                             "is absent — pass --device cpu)")
    parser.add_argument("--num-envs", type=int, default=HEADLINE[0])
    parser.add_argument("--num-steps", type=int, default=HEADLINE[1])
    return parser


def main(argv=None) -> dict:
    """Run the benchmark; print its JSON line and return it with the
    per-route rates and mean rewards."""
    ns = build_parser().parse_args(argv)
    device = resolve_device(ns.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})", file=sys.stderr)
    routes = {"fused": measure_fused}
    if ns.plain:
        routes["plain"] = measure_plain
    rates, mean_rewards = {}, {}
    for route, measure in routes.items():
        rates[route], mean_rewards[route] = measure(ns.num_envs, ns.num_steps,
                                                    device)
    if ns.plain:
        print(f"fused/plain speedup: {rates['fused'] / rates['plain']:.2f}x",
              file=sys.stderr)
    result = {"metric": "env_steps_per_s", "value": max(rates.values()),
              "unit": "steps/s"}
    print(json.dumps(result))
    return {**result, "routes": rates, "mean_rewards": mean_rewards,
            "device": name}


if __name__ == "__main__":
    main()
