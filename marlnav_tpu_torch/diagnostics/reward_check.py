"""Reward-check harness: golden-trajectory plots for scripted scenarios.

Port of ``marlnav_tpu/diagnostics/reward_check.py``, the reference's
``check_rews`` (reference utils.py:579-666): step the env ``num_steps``
times with scripted actions, then save

  plots/states_array_{p}_agent_{a}.png   4x2 grid of 8 observation
                                         channels of one (env, agent)
  plots/rewards_B{p}A{a}T{t}H{h}D{d}R{r}S{s}.png   the reward curve

The reward filename keeps the reference's quirk of dropping the bond
factor: its format string has 7 placeholders for 8 arguments (reference
utils.py:659-662), so runs of either package produce comparable artifact
sets.  The plots need matplotlib; where it is not installed they are left
out with a note, as the trainer's are (``utils/stats.py``), and the series
are returned all the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from marlnav_tpu_torch.diagnostics.trajectory import rollout_trajectory
from marlnav_tpu_torch.env.env import Env
from marlnav_tpu_torch.utils.seeding import make_generator
from marlnav_tpu_torch.utils.stats import _pyplot


def _save_plot(plt, fig, filename: str, directory: str) -> None:
    """(reference utils.py:571-576)"""
    os.makedirs(directory, exist_ok=True)
    fig.savefig(os.path.join(directory, filename))
    plt.close(fig)


def check_rews(env: Env, num_steps: int, parallel_ind: int, agent_ind: int,
               generator: Optional[torch.Generator] = None,
               plots_dir: str = "plots") -> dict:
    """Save the state and reward diagnostic plots; returns the series.

    The signature mirrors the reference's (env, num_steps, parallel_ind,
    agent_ind; reference utils.py:579).  ``generator`` (default: seed 0 on
    the env's device) seeds the env's init, which only the triangle
    initializer's obstacle draw consumes; the mock paths draw nothing."""
    if generator is None:
        generator = make_generator(0, env.device)
    traj = rollout_trajectory(env, num_steps, generator)
    obs = traj.obs

    neighbour_inds = sorted(set(range(env.params.num_agents)) - {agent_ind})
    first, second = neighbour_inds[0], neighbour_inds[1]
    pi, ai = parallel_ind, agent_ind
    series = {
        "target_angles": obs.target_angle[:, pi, ai, 0],
        "target_distances": obs.target_distance[:, pi, ai, 0],
        "obs_angles": obs.obstacles_angles[:, pi, ai, 0],
        "obs_distances": obs.obstacles_distances[:, pi, ai, 0],
        "angles_to_first": obs.others_angles[:, pi, ai, 0],
        "distances_to_first": obs.others_distances[:, pi, ai, 0],
        "angles_to_second": obs.others_angles[:, pi, ai, 1],
        "distances_to_second": obs.others_distances[:, pi, ai, 1],
        "rewards": traj.rewards[:, pi],
    }
    series = {k: np.asarray(v) for k, v in series.items()}

    plt = _pyplot()
    if plt is None:
        print("matplotlib is not installed: the reward-check plots are "
              "left out")
        return series

    # 4x2 observation-channel grid (reference utils.py:616-646).
    pi_plus = 3.5
    fig, axs = plt.subplots(4, 2, figsize=(10, 10))
    panels = [
        ("target_angles", "Angle to target (rad)", True),
        ("target_distances", "Distance to target", False),
        ("obs_angles", "Angle to obstacle (rad)", True),
        ("obs_distances", "Distance to obstacle", False),
        ("angles_to_first", f"Angle to agent {first} (rad)", True),
        ("distances_to_first", f"Distance to agent {first}", False),
        ("angles_to_second", f"Angle to agent {second} (rad)", True),
        ("distances_to_second", f"Distance to agent {second}", False),
    ]
    for ax, (key, title, is_angle) in zip(axs.flat, panels):
        ax.plot(series[key])
        ax.set_title(title)
        if is_angle:
            ax.set_ylim([-pi_plus, pi_plus])
        ax.set(xlabel="step number", ylabel="value")
    fig.tight_layout(pad=5.0)
    fig.suptitle(
        f"States, parallel index: {parallel_ind}, agent index: {agent_ind}")
    _save_plot(plt, fig, f"states_array_{parallel_ind}_agent_{agent_ind}.png",
               plots_dir)

    # Reward curve (reference utils.py:648-666).
    p = env.params
    fig, ax = plt.subplots(1, 1)
    ax.set(xlabel="step number", ylabel="value")
    ax.plot(series["rewards"])
    fig.suptitle(
        f"Rewards, parallel index: {parallel_ind}, agent index: {agent_ind}"
        + f"\n Factors: tar {p.target_factor}, hea {p.heading_factor}"
        + f", dis {p.distance_factor}, ris {p.risk_factor},"
        + f" sof {p.soft_factor} bof {p.bond_factor}"
    )
    # 7 placeholders for 8 factors: the bond factor is absent from the
    # filename, as in the reference (utils.py:659-662).
    _save_plot(
        plt, fig,
        "rewards_B{0}A{1}T{2}H{3}D{4}R{5}S{6}.png".format(
            parallel_ind, agent_ind, p.target_factor, p.heading_factor,
            p.distance_factor, p.risk_factor, p.soft_factor, p.bond_factor),
        plots_dir,
    )
    return series
