"""The numbers that decide ``correct``: what the program produced, held
against the reference.

Train cells, for each compared repeat (the worst of the three is kept):

* ``rows_gap``: the largest absolute difference of the env rows after the
  repeat's collect (positions, headings, speeds, obstacles, counters);
  the collect is the reference's float32 arithmetic operation for
  operation, so a sound run reads 0.
* ``counts_gap``: the largest difference of the repeat's episode counts
  (truncations, collisions, steps with all agents in the target).
* ``mean_rew_gap``: the repeat's mean return, relative.
* ``actor_loss_gap``, ``critic_loss_gap``: the loss of each of the first
  ``STEADY_STEPS`` Adam steps of the phase against the reference's,
  relative to the larger of its own size and the median step's.
* ``actor_loss_gap_first_steps``: as ``actor_loss_gap`` over the first
  ``FIRST_STEPS`` steps alone, which the actor at 17 obstacles compares:
  there a sound seed's actor can part from the float64 reference inside
  its first ten steps, as float32's does.
* ``actor_update_gap``, ``critic_update_gap``: for each leaf of the
  network, the gap between the norms of the program's and the
  reference's change over the repeat, relative to the larger of the
  reference's and the median leaf's; the worst actor leaf, the median
  critic leaf.
* ``adam_m_gap``, ``adam_v_gap``, ``adam_step_gap``: Adam's state after
  the repeat, which the next repeat starts from: for each network the
  median leaf's gap of the norms of its first moment, and of its second
  (as the change above), the worse network's; and the largest difference
  of a leaf's step count.

Leaves whose first reference gradient is under a thousandth of the
median leaf's move by round-off alone under Adam and are left out.

Why the early steps, the median critic leaf and not every number in
every cell: at the default configuration's clips (epsilon 0.01 on the
ratio and on the value) either phase can part from the float64
reference in its later steps, in float32 as in the program, as rows come
to lie on the other side of a clip edge, and Adam carries the difference
on (the look in ``PERF.md``, ``benchmark/clip_look.py``).  The readings
that carry it are kept beside the others (``actor_loss_gap_all_steps``,
``critic_loss_gap_all_steps``, ``critic_update_gap_worst_leaf``) and
compared where a cell holds them.

Rollout cells, for each sampled call: ``rows_gap`` of its final rows and
``reward_gap``, the largest absolute difference of its (T, P) rewards.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

ROW_FIELDS = ("px", "py", "dx", "dy", "sp", "obx", "oby", "tg", "misc")
# Below this share of the median leaf's first gradient a leaf's gradient
# is nought to rounding.
NOUGHT_GRADIENT = 1e-3
# A phase's first Adam steps, whose losses are compared.
STEADY_STEPS = 10
# The actor's first Adam steps, before rounding that rows near the ratio
# clip carry on can part it from the reference.
FIRST_STEPS = 3


def rows_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor]) -> float:
    return max(float(torch.max(torch.abs(program[k] - reference[k])))
               for k in ROW_FIELDS)


def _losses_gap(program: torch.Tensor, reference: torch.Tensor,
                steps: int = None) -> float:
    ref = reference.abs()
    scale = torch.clamp_min(ref, float(torch.median(ref)))
    return float(torch.max((torch.abs(program - reference) / scale)[:steps]))


def _moved(ref: dict, net: str) -> List[str]:
    """The leaves of ``net`` whose first gradient is not nought."""
    grads = ref["first_grad_norms"][net]
    floor = NOUGHT_GRADIENT * statistics.median(float(g)
                                                for g in grads.values())
    return [name for name, g in grads.items() if float(g) >= floor]


def _norm_gaps(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor]) -> List[float]:
    """Per leaf, the gap of the norms relative to the larger of the
    reference's and the median leaf's."""
    norms = {k: (float(torch.linalg.vector_norm(program[k])),
                 float(torch.linalg.vector_norm(
                     reference[k].to(program[k].device))))
             for k in program}
    median = statistics.median(r for _, r in norms.values())
    return [abs(p - r) / max(r, median, 1e-30) for p, r in norms.values()]


def leaf_gaps(start: dict, end: dict, ref: dict, net: str) -> List[float]:
    """The change of each moved leaf of ``net`` over the repeat."""
    keys = _moved(ref, net)
    return _norm_gaps({k: end[net][k] - start[net][k] for k in keys},
                      {k: ref[net][k].to(start[net][k].device)
                       - start[net][k] for k in keys})


def adam_gaps(end: dict, ref: dict) -> Dict[str, float]:
    def moment(j: int) -> float:
        return max(statistics.median(_norm_gaps(
            {k: end[net + ("_m", "_v")[j]][k] for k in _moved(ref, net)},
            {k: ref["adam"][net][k][j] for k in _moved(ref, net)}))
            for net in ("actor", "critic"))

    steps = [abs(float(end[net + "_t"][k]) - ref["adam"][net][k][2])
             for net in ("actor", "critic") for k in _moved(ref, net)]
    return {"adam_m_gap": moment(0), "adam_v_gap": moment(1),
            "adam_step_gap": max(steps)}


def train_numbers(block_row, start: dict, end: dict, ref: dict,
                  n_losses: int) -> Dict[str, float]:
    """The numbers of one compared repeat.  ``block_row`` is the
    program's row of the block it ran in: [mean return, truncations,
    collisions, in target, actor losses, critic losses]; ``start`` and
    ``end`` the program's state at the repeat's start and end."""
    row = torch.as_tensor(block_row, dtype=torch.float64)
    counts = ref["counts"].to(torch.float64).cpu()
    mean_ref = float(ref["mean_rew"])
    actor = (row[4:4 + n_losses], ref["actor_losses"].cpu().double())
    critic = (row[4 + n_losses:4 + 2 * n_losses],
              ref["critic_losses"].cpu().double())
    critic_leaves = leaf_gaps(start, end, ref, "critic")
    return {
        "rows_gap": rows_gap(end["rows"], ref["rows"]),
        "counts_gap": float(torch.max(torch.abs(row[1:4] - counts))),
        "mean_rew_gap": abs(float(row[0]) - mean_ref) / max(abs(mean_ref),
                                                            1e-30),
        "actor_loss_gap": _losses_gap(*actor, STEADY_STEPS),
        "actor_loss_gap_first_steps": _losses_gap(*actor, FIRST_STEPS),
        "critic_loss_gap": _losses_gap(*critic, STEADY_STEPS),
        "actor_update_gap": max(leaf_gaps(start, end, ref, "actor")),
        "critic_update_gap": statistics.median(critic_leaves),
        **adam_gaps(end, ref),
        "actor_loss_gap_all_steps": _losses_gap(*actor),
        "critic_loss_gap_all_steps": _losses_gap(*critic),
        "critic_update_gap_worst_leaf": max(critic_leaves)}


def rollout_numbers(rows: dict, rewards: torch.Tensor, ref_rows: dict,
                    ref_rewards: torch.Tensor) -> Dict[str, float]:
    return {"rows_gap": rows_gap(rows, ref_rows),
            "reward_gap": float(torch.max(torch.abs(rewards - ref_rewards)))}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
