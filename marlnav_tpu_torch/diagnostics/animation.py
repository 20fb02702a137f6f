"""Trajectory renderer: a matplotlib animation of the agents' movements.

Port of ``marlnav_tpu/diagnostics/animation.py``, the reference's
``Animation`` / ``init_render`` (reference animation.py:12-96): the whole
trajectory is rolled out first on the env's device and fetched once
(``rollout_trajectory``); the figure only replays host arrays, with no
per-frame device stepping or copy (reference animation.py:55-69 does
both every frame).

Policy mode loads ``weights/<ts>_actor.npz`` files written by either
package's trainer (reference: torch state_dicts, animation.py:84-89) and
drives the env with the policy mean, or with samples where ``random``
(reference animation.py:42-50).  Rendering needs matplotlib: where it is
not installed, building the renderer raises ``ModuleNotFoundError`` naming
it; the file that was asked for is never silently skipped.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from marlnav_tpu_torch.config import (AnimationConfig, NormalizerConfig,
                                      ScalerConfig)
from marlnav_tpu_torch.diagnostics.trajectory import (Trajectory,
                                                      rollout_trajectory)
from marlnav_tpu_torch.env.env import Env
from marlnav_tpu_torch.utils.seeding import make_generator


def _require_pyplot():
    """matplotlib's pyplot, or ModuleNotFoundError naming matplotlib."""
    try:
        import matplotlib.pyplot as plt
    except ModuleNotFoundError as err:
        raise ModuleNotFoundError(
            "rendering (-re) needs matplotlib, which is not installed; "
            "install it or use the reward check (-rc), whose series need "
            "no plots") from err
    return plt


def _init_figure(plt, cfg: AnimationConfig, agents_pos, obstacles_pos,
                 target_pos):
    """Arena figure and scatter artists (reference utils.py:500-516)."""
    fig = plt.figure(figsize=(cfg.fig_size_x, cfg.fig_size_y))
    ax = fig.add_axes([0, 0, 1, 1], frameon=False)
    ax.set_xlim(0, cfg.max_x_value)
    ax.set_xticks([])
    ax.set_ylim(0, cfg.max_y_value)
    ax.set_yticks([])
    agents = ax.scatter(agents_pos[:, 0], agents_pos[:, 1], s=10, lw=0.5,
                        c=np.array([(0.0, 0.0, 0.0, 1.0)]))
    obs1 = ax.scatter(obstacles_pos[:, 0], obstacles_pos[:, 1], s=2200,
                      lw=0.5, c=np.array([(1.0, 0.5, 0.5, 1.0)]))
    obs2 = ax.scatter(obstacles_pos[:, 0], obstacles_pos[:, 1], s=1500,
                      lw=0.5, c=np.array([(1.0, 0.0, 0.0, 1.0)]))
    target = ax.scatter(target_pos[:, 0], target_pos[:, 1], s=2000,
                        facecolors="w", lw=1.5, edgecolors="k",
                        linestyle=":")
    return fig, agents, obs1, obs2, target


class Animation:
    """Replay a finished trajectory of one parallel-env index."""

    def __init__(self, env: Env, cfg: AnimationConfig,
                 trajectory: Trajectory):
        plt = _require_pyplot()
        self.cfg = cfg
        self.traj = trajectory
        pi = cfg.parallel_index
        (fig, self.agents_scatter, self.obs_scatter1, self.obs_scatter2,
         self.target_scatter) = _init_figure(
            plt, cfg, trajectory.states[0, pi, :, :2],
            trajectory.obstacles[0, pi], trajectory.target[0, pi])
        try:
            fig.canvas.manager.set_window_title("marlnav-tpu")
        except AttributeError:
            pass  # headless backends
        self.fig = fig

    def update(self, frame_number: int):
        """Move the scatter artists to frame ``frame_number``'s positions
        (the post-step state, as in reference animation.py:64-69)."""
        pi = self.cfg.parallel_index
        self.agents_scatter.set_offsets(
            self.traj.states[frame_number, pi, :, :2])
        obstacles = self.traj.obstacles[frame_number, pi]
        self.obs_scatter1.set_offsets(obstacles)
        self.obs_scatter2.set_offsets(obstacles)
        self.target_scatter.set_offsets(self.traj.target[frame_number, pi])
        return (self.agents_scatter, self.obs_scatter1, self.obs_scatter2,
                self.target_scatter)

    def run(self, show: bool = True, save_path: Optional[str] = None):
        """Run the animation: write it to ``save_path`` (a GIF or movie
        file) where given, else open a window where ``show``."""
        plt = _require_pyplot()
        from matplotlib.animation import FuncAnimation

        anim = FuncAnimation(self.fig, self.update,
                             frames=self.traj.states.shape[0], repeat=False,
                             interval=self.cfg.interval, blit=True)
        if save_path is not None:
            anim.save(save_path)
        elif show:
            plt.show()
        return anim


def load_actor_weights(weights_file: str, obs_size: int,
                       hidden_size: int = 50, action_size: int = 2,
                       device="cpu"):
    """An ``Actor`` on ``device`` with the weights of a trainer-written
    ``.npz`` file of either package.  ``weights_file`` resolves relative to
    ``./weights`` where it is not a path that exists (reference
    animation.py:85-86)."""
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.utils.stats import load_weights

    path = weights_file
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(os.getcwd(), "weights", weights_file)
    actor = load_weights(path, Actor(obs_size, hidden_size, action_size))
    return actor.to(device)


def init_render(env: Env, cfg: AnimationConfig,
                normalizer_cfg: Optional[NormalizerConfig] = None,
                scaler_cfg: Optional[ScalerConfig] = None,
                hidden_size: int = 50,
                generator: Optional[torch.Generator] = None) -> Animation:
    """Build the renderer (reference animation.py:80-96): policy mode loads
    trained weights and rolls out mean or sampled actions; sampler mode the
    env's scripted sampler.  ``generator`` (default: seed 0 on the env's
    device) seeds the rollout."""
    _require_pyplot()
    if generator is None:
        generator = make_generator(0, env.device)
    if cfg.sampling_style == "policy":
        if cfg.weights_file is None:
            raise ValueError("policy rendering needs a weights_file")
        actor = load_actor_weights(cfg.weights_file, env.params.obs_size,
                                   hidden_size, device=env.device)
        traj = rollout_trajectory(
            env, cfg.max_step, generator, actor=actor,
            normalizer_cfg=normalizer_cfg, scaler_cfg=scaler_cfg,
            sample=cfg.random)
    elif cfg.sampling_style == "sampler":
        traj = rollout_trajectory(env, cfg.max_step, generator)
    else:
        raise NotImplementedError(f"sampling_style {cfg.sampling_style!r}")
    return Animation(env, cfg, traj)
