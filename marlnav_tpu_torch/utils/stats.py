"""Training statistics, plots, CSV logs and weight files.

Port of ``marlnav_tpu/utils/stats.py``; the same artifact set as the
reference trainer (reference models.py:200-268), per-run timestamped:

  plots/<ts>_mean_rews.png   plots/<ts>_act_loss.png
  plots/<ts>_cri_loss.png    plots/<ts>_epi_stats.png
  logs/<ts>_mean_rews.csv    logs/<ts>_act_loss.csv
  logs/<ts>_cri_loss.csv     logs/<ts>_epi_stats.csv
  logs/<ts>_params.json
  weights/<ts>_{actor,critic}.npz

The PNG plots need matplotlib; where it is not installed they are left
out and ``save_stats`` prints a note.  Weight files use the JAX package's
``.npz`` keys and layout ("fc1.w" as (in, out), ...), so either package
loads the other's weights.
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Optional

import numpy as np

from marlnav_tpu_torch.models.networks import flat_params, load_flat_params


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed: the CSV and JSON artifacts are then written without the
    PNG plots, and ``save_stats`` says so."""
    try:
        import matplotlib
    except ModuleNotFoundError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot(plt, stats, xlabel: str, title: str, filename: str) -> None:
    fig, ax = plt.subplots(1, 1)
    ax.set(xlabel=xlabel, ylabel="value")
    ax.plot(stats)
    fig.suptitle(title)
    fig.savefig(filename)
    plt.close(fig)


class StatsLogger:
    """Accumulates per-rollout / per-batch training statistics on the host
    (reference models.py:84-104, 145-158, 200-268)."""

    def __init__(self, root: Optional[str] = None,
                 timestamp: Optional[str] = None, writes: bool = True):
        root = root or os.getcwd()
        self.wpath = os.path.join(root, "weights")
        self.ppath = os.path.join(root, "plots")
        self.lpath = os.path.join(root, "logs")
        # A data-parallel rank other than 0 keeps the logs but writes
        # nothing (only rank 0 writes, as only process 0 does in the JAX
        # package's runs).
        self.writes = writes
        if writes:
            for p in (self.wpath, self.ppath, self.lpath):
                os.makedirs(p, exist_ok=True)
        self.time = timestamp or datetime.now().strftime("%Y%m%d%H%M%S")
        self.logs = {
            "epi_stats": {"trunc": [], "col": [], "tar": []},
            "mean_rews": [],
            "actor": [],
            "critic": [],
        }

    # -- accumulation ------------------------------------------------------

    def log_rollout(self, metrics) -> None:
        """Record one rollout's mean return + episode-ending counters
        (reference models.py:145-158)."""
        self.logs["mean_rews"].append(float(metrics.mean_rew))
        self.logs["epi_stats"]["trunc"].append(int(metrics.stats.num_trunc))
        self.logs["epi_stats"]["col"].append(int(metrics.stats.num_col))
        self.logs["epi_stats"]["tar"].append(int(metrics.stats.num_tar))

    def log_losses(self, actor_losses, critic_losses) -> None:
        """Record per-minibatch losses.  The actor losses are negated back to
        the maximized objective the reference logs (reference models.py:178)."""
        self.logs["actor"].extend(
            (-actor_losses.detach().cpu().numpy()).tolist())
        self.logs["critic"].extend(critic_losses.detach().cpu().numpy().tolist())

    # -- checkpoint round trip (for resume) ---------------------------------

    def state_dict(self) -> dict:
        """The host state a checkpoint keeps (marlnav_tpu/utils/stats.py:
        150-155): the run's timestamp and every log so far."""
        return {"time": self.time, "logs": self.logs}

    def load_state_dict(self, state: dict) -> None:
        self.time = state["time"]
        self.logs = state["logs"]

    # -- persistence -------------------------------------------------------

    def save_weights(self, train_state) -> None:
        """One ``.npz`` per network in the JAX package's key format."""
        if not self.writes:
            return
        for name, module in (("actor", train_state.actor),
                             ("critic", train_state.critic)):
            np.savez(os.path.join(self.wpath, f"{self.time}_{name}.npz"),
                     **flat_params(module))

    def save_stats(self, params_json: str) -> None:
        """Write all plot/CSV/params artifacts (reference models.py:200-231)."""
        if not self.writes:
            return
        t = self.time
        plt = _pyplot()
        if plt is None:
            print("matplotlib is not installed: the PNG plots are left out")
        else:
            for key, fname, xlabel, title in (
                    ("mean_rews", "mean_rews", "rollout_num", "Mean Rewards"),
                    ("actor", "act_loss", "batch_num", "Actor Losses"),
                    ("critic", "cri_loss", "batch_num", "Critic Losses")):
                _plot(plt, self.logs[key], xlabel, title,
                      os.path.join(self.ppath, f"{t}_{fname}.png"))
            self._plot_epi_stats(plt,
                                 os.path.join(self.ppath, f"{t}_epi_stats.png"))

        with open(os.path.join(self.lpath, f"{t}_params.json"), "w") as f:
            f.write(params_json)

        for key, fname in (("mean_rews", "mean_rews"), ("actor", "act_loss"),
                           ("critic", "cri_loss")):
            with open(os.path.join(self.lpath, f"{t}_{fname}.csv"), "w",
                      newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["Value"])
                writer.writerows([[v] for v in self.logs[key]])

        epi = self.logs["epi_stats"]
        with open(os.path.join(self.lpath, f"{t}_epi_stats.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Truncated", "Collisions", "Target reached"])
            writer.writerows(zip(epi["trunc"], epi["col"], epi["tar"]))

    def _plot_epi_stats(self, plt, plotfile: str) -> None:
        epi = self.logs["epi_stats"]
        fig, ax = plt.subplots(1, 1)
        ax.set(xlabel="rollout", ylabel="value")
        ax.plot(epi["trunc"], color="blue", label="truncated")
        ax.plot(epi["col"], color="red", label="collisions")
        ax.plot(epi["tar"], color="green", label="target reached")
        ax.legend()
        fig.suptitle("Episode endings")
        fig.savefig(plotfile)
        plt.close(fig)


def load_weights(path: str, module):
    """Load a ``.npz`` weight file (written by either package) into
    ``module`` in place, checking every shape; returns the module."""
    with np.load(path) as data:
        return load_flat_params(module, dict(data))
