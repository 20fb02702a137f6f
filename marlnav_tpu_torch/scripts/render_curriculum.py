"""Replay a curriculum-trained actor and count the envs whose agents reach
the target disk together.

Port of ``scripts/render_curriculum.py``.  Same flags and defaults, plus
``--device`` (default ``cuda``; raises without a card unless ``--device
cpu``); the default ``--out`` lies under ``runs/``.  The actor file is a
``.npz`` of either package (``diagnostics.animation.load_actor_weights``;
the curriculum writes one a stage).  ``--envs`` episodes are rolled out
with sampled actions (``diagnostics.trajectory.rollout_trajectory``); the
JSON line of reach statistics is printed before the animation of the
earliest reaching env (or the closest approach) is drawn, which needs
matplotlib: without it the run raises ``ModuleNotFoundError`` naming
matplotlib after the statistics are out.

Usage: python -m marlnav_tpu_torch.scripts.render_curriculum [--radius 255]
       [--envs 256] [--steps 200] [--weights docs/curriculum_r2_actor.npz]
       [--out runs/curriculum_policy.gif] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from marlnav_tpu_torch.config import (AnimationConfig, EnvParams,
                                      NormalizerConfig, ScalerConfig,
                                      TriangleInitConfig)
from marlnav_tpu_torch.diagnostics.animation import (Animation,
                                                     load_actor_weights)
from marlnav_tpu_torch.diagnostics.trajectory import rollout_trajectory
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.utils.seeding import make_generator


def reach_stats(traj, radius: float) -> dict:
    """Group reaches of a trajectory: every agent inside the disk on the
    same frame (the env's own criterion).  Returns the envs with one, the
    closest group approach, and the env to render: the earliest reach
    (with its frame), else the closest approach."""
    pos = traj.states[..., :2]  # (T, P, A, 2)
    dist = np.linalg.norm(pos - traj.target, axis=-1)  # (T, P, A)
    group_in = (dist < radius).all(axis=-1)  # (T, P)
    reached = group_in.any(axis=0)  # (P,)
    stats = {"envs_with_group_reach": int(reached.sum()),
             "closest_group_approach": float(dist.max(axis=-1).min())}
    if reached.any():
        first_t = np.where(group_in.any(axis=1))[0][0]
        stats["rendered_env"] = int(np.where(group_in[first_t])[0][0])
        stats["reach_frame"] = int(first_t)
    else:
        stats["rendered_env"] = int(dist.max(axis=-1).min(axis=0).argmin())
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m marlnav_tpu_torch.scripts.render_curriculum",
        description=__doc__.splitlines()[0])
    ap.add_argument("--radius", type=float, default=255.0)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--episode-len", type=int, default=200,
                    help="match the training truncation horizon (the "
                         "small-radius recipe trains at 400)")
    ap.add_argument("--weights", type=str,
                    default="docs/curriculum_r2_actor.npz")
    ap.add_argument("--out", type=str, default="runs/curriculum_policy.gif")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: cuda; raises "
                         "without a card)")
    return ap


def main(argv=None) -> dict:
    """Roll out, print the statistics, then write the animation; returns
    the statistics."""
    ns = build_parser().parse_args(argv)
    p = ns.envs
    env = make_env(EnvParams(num_parallel=p, risk_factor=250.0,
                             target_radius=ns.radius,
                             episode_len=ns.episode_len),
                   TriangleInitConfig(num_parallel=p, num_obstacles=3),
                   ns.device)
    actor = load_actor_weights(ns.weights, env.params.obs_size,
                               device=env.device)
    traj = rollout_trajectory(env, ns.steps,
                              make_generator(ns.seed, env.device),
                              actor=actor, normalizer_cfg=NormalizerConfig(),
                              scaler_cfg=ScalerConfig(), sample=True)
    stats = {"radius": ns.radius, "envs": p, "steps": ns.steps,
             **reach_stats(traj, ns.radius)}
    print(json.dumps(stats), flush=True)

    cfg = AnimationConfig(parallel_index=stats["rendered_env"],
                          max_step=ns.steps)
    anim = Animation(env, cfg, traj).run(show=False, save_path=None)
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    anim.save(ns.out, writer="pillow", fps=25, dpi=50)
    print("wrote", ns.out, flush=True)
    return stats


if __name__ == "__main__":
    main()
