"""Obstacle-corridor and target-radius curricula: staged geometry, one
continuing policy.

Port of ``scripts/curriculum.py``.  Same modes, flags, defaults, printed
JSON lines and files, with two differences: ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``), and the default
``--out`` is ``runs/curriculum_r2`` (the JAX program's default writes
into ``docs/``).

* ``--mode obstacles | radius | none``: fixed stages (``stage_geometry``)
  at 2048 envs x 200 steps, ``--repeats-per-stage`` repeats each.
* ``--mode radius-adaptive``: 4096 envs x 200 steps, entropy 1e-2; the
  target radius shrinks 15% after each stage whose last quarter ends more
  than 2% of its episodes in a group reach (``adaptive_gate``).
* ``--mode radius-noise-adaptive``: the same envs; each anneal also
  halves the entropy bonus (floor ``--ent-floor``) and shifts the
  variance head's bias by ``--var-shift``; a collapse restores the last
  good state (``noise_adaptive_gate``, which holds every rule of the
  schedule as a pure function of the stage's counts).  ``--mean-eval``,
  ``--save-state`` / ``--resume-state`` (the port's own file or a JAX
  ``.pkl``, read by ``utils/jax_state.py``), ``--consolidate``,
  ``--restore-reheat`` and the rest as in the JAX program.

A repeat is the fused collect, then 10 actor and 10 critic epochs at full
batch through the fused update kernels (lr 3e-4, gamma 0.99, epsilon 0.2,
GAE, fixed semantics, staggered resets); repeat ``gr`` of the run takes
the kernel seed ``base_seed + gr``, ``base_seed = (seed * 1,000,003) mod
2**30``.  Each stage builds its env, MAPPO bundle and collect anew, as the
JAX program does; the kernels take the stage's constants at run time, so
no stage builds a kernel.  Repeats run in blocks of 25 (``BLOCK``): a
block's episode counts come back in one read, and on the card every block
of a stage after its first replays one repeat's CUDA graph
(``train._Blocks``).  The live state is held by tensors that graphs and
wrappers keep, so the restore point is a deep copy (``Snapshot``) and a
restore copies it back into those tensors.

Usage: python -m marlnav_tpu_torch.scripts.curriculum
       [--repeats-per-stage 300]
       [--mode obstacles|radius|radius-adaptive|radius-noise-adaptive|none]
       [--out runs/curriculum_r2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import time
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.algo.mappo import TrainState, make_adam
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                      NormalizerConfig, ScalerConfig,
                                      TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, Critic
from marlnav_tpu_torch.models.networks import flat_params
from marlnav_tpu_torch.ops.fused_collect import (RowState, env_state_to_rows,
                                                 make_fused_collect)
from marlnav_tpu_torch.ops.fused_rollout import make_fused_rollout
from marlnav_tpu_torch.train import (_Blocks, _copy_state, restore_adam,
                                     tiled_route, uncollapsed_actor)
from marlnav_tpu_torch.utils.jax_state import SCHEDULE_KEYS, load_jax_state
from marlnav_tpu_torch.utils.seeding import make_generator, resolve_device

# Envs and steps of a repeat: the fixed modes', the adaptive modes'.
P, T = 2048, 200
P_ADAPTIVE, T_ADAPTIVE = 4096, 200
# Repeats a block: one read of the episode counts, one graph's replays.
BLOCK = 25
REFERENCE_RADIUS = 30.0
STATE_FORMAT = "marlnav_tpu_torch curriculum state"


def build_cfg(p: int = P, t: int = T, **kw) -> MAPPOConfig:
    """The sweep's best-learning cell: GAE, fixed semantics, full batch,
    10 + 10 epochs, lr 3e-4, gamma 0.99, epsilon 0.2, fused updates."""
    return MAPPOConfig(num_parallel=p, buffer_len=t, batch_size=t,
                       num_epochs=10, num_total=t * p, lr=3e-4, gamma=0.99,
                       epsilon=0.2, use_gae=True, faithful=False,
                       fused_updates=True, **kw)


def stage_geometry(mode):
    """Per-stage (label, env-param overrides, init-config overrides) of the
    fixed modes (scripts/curriculum.py stage_geometry)."""
    if mode == "obstacles":
        # The obstacle box slides from below the corridor (the flight path
        # runs at y ~375) up to the reference position (250-500).
        return [
            ("box y 40-160", {}, {"obst_min_y": 40.0, "obst_max_y": 160.0}),
            ("box y 150-330", {}, {"obst_min_y": 150.0, "obst_max_y": 330.0}),
            ("box y 200-420", {}, {"obst_min_y": 200.0, "obst_max_y": 420.0}),
            ("box y 250-500 (reference)", {}, {}),
        ]
    if mode == "radius":
        # An enlarged target disk shrinks to the reference 30.
        return [
            ("target radius 150", {"target_radius": 150.0}, {}),
            ("target radius 90", {"target_radius": 90.0}, {}),
            ("target radius 50", {"target_radius": 50.0}, {}),
            ("target radius 30 (reference)", {}, {}),
        ]
    return [("reference geometry (control)", {}, {})]


# ----------------------------------------------------------------------
# The schedules, as pure functions of a stage's counts
# ----------------------------------------------------------------------

def share_of(tar: int, col: int, trunc: int) -> float:
    """Group reaches over all episode endings (0 with none)."""
    endings = tar + col + trunc
    return tar / endings if endings else 0.0


def quarter_counts(packed: np.ndarray) -> Tuple[int, int, int]:
    """``(tar, col, trunc)`` summed over the last quarter of a stage, the
    repeats ``r >= n - n // 4`` of its (n, 4 + 2L) block rows
    (``train.pack_block``: mean_rew, truncations, collisions, reaches)."""
    n = packed.shape[0]
    tail = packed[n - n // 4:]
    return (int(tail[:, 3].sum()), int(tail[:, 2].sum()),
            int(tail[:, 1].sum()))


def adaptive_gate(radius, share: float):
    """``--mode radius-adaptive``: the next stage's radius."""
    return round(radius * 0.85) if share > 0.02 else radius


def stage_params(radius, ns) -> Tuple[float, int, float]:
    """``(target_factor, episode_len, group_soft_factor)`` of a
    noise-adaptive stage at ``radius``."""
    # --bonus-scale (density-compensated bonus): measured harmful, kept for
    # the record.
    tf = (500_000.0 * (300.0 / max(radius, REFERENCE_RADIUS))
          if ns.bonus_scale else 500_000.0)
    ep_len = (ns.episode_len_small
              if ns.episode_len_small and radius <= ns.episode_len_radius
              else 200)
    gsf = ns.group_soft if radius <= ns.group_soft_radius else 0.0
    return tf, ep_len, gsf


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The noise-adaptive schedule's position: the next stage's radius and
    entropy bonus, the stages run, the collapse watch's stall count, the
    streak of gate clears at the reference radius, and the restore
    point's ``(share, radius, ent)`` (None before the first)."""

    radius: float = 300.0
    ent: float = 1e-2
    stage: int = 0
    stall: int = 0
    consec: int = 0
    best: Optional[Tuple[float, float, float]] = None


@dataclasses.dataclass(frozen=True)
class Gate:
    """What a noise-adaptive stage's counts decide.

    ``cleared``: the live state becomes the restore point (and the
    ``--save-state`` file), before ``var_shift`` is added to the variance
    head's bias (an anneal).  ``restored``: the restore point is copied
    back into the live state, then its ``reheat`` added to the variance
    head's bias; the dict is the stage record's ``restored`` entry.
    ``solved`` ends the run.  ``lines``: JSON objects to print, in order."""

    schedule: Schedule
    cleared: bool = False
    var_shift: float = 0.0
    restored: Optional[dict] = None
    solved: bool = False
    lines: tuple = ()


def noise_adaptive_gate(s: Schedule, tar: int, col: int, trunc: int,
                        ns) -> Gate:
    """The noise-adaptive schedule after a stage run at ``s.radius`` /
    ``s.ent`` with these last-quarter counts (scripts/curriculum.py
    run_noise_adaptive, after the stage)."""
    share = share_of(tar, col, trunc)
    radius = s.radius
    threshold = ns.coarse_threshold if radius > 200 else ns.fine_threshold
    consec = s.consec
    if not (radius <= REFERENCE_RADIUS and share > threshold):
        consec = 0  # consolidation counts consecutive radius-30 clears
    if share > threshold:
        best = (share, radius, s.ent)
        if radius <= REFERENCE_RADIUS:
            # A clear at the reference radius: no anneal while holding.
            consec += 1
            lines = [{"reference_radius_stage_cleared": {
                "share": share, "tar": tar, "consecutive": consec,
                "needed": max(1, ns.consolidate)}}]
            solved = consec >= max(1, ns.consolidate)
            if solved:
                lines.append({"solved_at_reference_radius": {
                    "share": share, "tar": tar, "consecutive": consec}})
            return Gate(dataclasses.replace(s, stall=0, consec=consec,
                                            best=best),
                        cleared=True, solved=solved, lines=tuple(lines))
        # Gentler steps below 200; clamped at the reference radius.
        step = 0.85 if radius > 200 else 0.92
        return Gate(dataclasses.replace(
            s, radius=max(REFERENCE_RADIUS, round(radius * step)),
            ent=max(ns.ent_floor, s.ent * 0.5), stall=0, consec=consec,
            best=best), cleared=True, var_shift=ns.var_shift)
    if share < 0.005:
        # Collapse watch: two stages below 0.5% restore the last good
        # state and retry at a gentler radius, never below 30.
        stall = s.stall + 1
        if stall >= 2 and s.best is not None:
            _, b_radius, b_ent = s.best
            retry = max(REFERENCE_RADIUS,
                        round(min(radius / 0.92, b_radius * 0.96)))
            restored = {"from_radius": b_radius, "retry_radius": retry,
                        "reheat": ns.restore_reheat}
            return Gate(dataclasses.replace(
                s, radius=retry, ent=b_ent, stall=0, consec=consec),
                restored=restored, lines=({"restore": restored},))
        return Gate(dataclasses.replace(s, stall=stall, consec=consec))
    return Gate(dataclasses.replace(s, stall=0, consec=consec))


def resumed_schedule(saved: dict) -> Schedule:
    """The schedule a ``--resume-state`` run starts from: the file's
    radius, entropy and stage (0 where it has none), its state the restore
    point (share 0 where it has none)."""
    radius, ent = saved["radius"], saved["ent"]
    return Schedule(radius=radius, ent=ent, stage=saved.get("stage", 0),
                    best=(saved.get("share", 0.0), radius, ent))


# ----------------------------------------------------------------------
# The live state: snapshots, restores, files
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Snapshot:
    """A deep copy of the networks, the Adam states and the env rows."""

    actor: dict
    critic: dict
    actor_opt: dict
    critic_opt: dict
    rows: list

    @classmethod
    def take(cls, ts: TrainState, rows: RowState) -> "Snapshot":
        def params(m):
            return {k: v.detach().clone() for k, v in m.state_dict().items()}
        return cls(params(ts.actor), params(ts.critic),
                   copy.deepcopy(ts.actor_opt.state_dict()),
                   copy.deepcopy(ts.critic_opt.state_dict()),
                   [x.clone() for x in rows.fields()])

    @torch.no_grad()
    def restore(self, ts: TrainState, rows: RowState) -> None:
        """Copy the snapshot into the live tensors of ``ts`` and ``rows``,
        which graphs and wrappers may hold: nothing is rebound."""
        for module, opt, params, opt_state in (
                (ts.actor, ts.actor_opt, self.actor, self.actor_opt),
                (ts.critic, ts.critic_opt, self.critic, self.critic_opt)):
            module.load_state_dict(params)  # copies into the parameters
            # Optimizer.load_state_dict would put new tensors in its state.
            order = [q for group in opt.param_groups for q in group["params"]]
            for i, q in enumerate(order):
                for key, value in opt_state["state"][i].items():
                    opt.state[q][key].copy_(value)
        _copy_state(rows, RowState(*self.rows))


@torch.no_grad()
def shift_variance(actor: Actor, shift: float) -> None:
    """Add ``shift`` to the variance head's bias in place (Adam's state is
    left alone)."""
    actor.fc_var.bias.add_(shift)


def save_actor(path: str, actor: Actor) -> None:
    """The actor in the JAX package's ``.npz`` key layout (``fc1.w`` as
    (in, out), ...), which either package's renderer reads."""
    np.savez(path, **flat_params(actor))


def save_state(path: str, ts: TrainState, rows: RowState,
               **schedule) -> None:
    """The port's state file (``torch.save``): the networks' and Adam's
    state dicts, the rows and the schedule scalars.  ``load_state`` reads
    it on either device type."""
    torch.save({"format": STATE_FORMAT,
                "actor": ts.actor.state_dict(),
                "critic": ts.critic.state_dict(),
                "actor_opt": ts.actor_opt.state_dict(),
                "critic_opt": ts.critic_opt.state_dict(),
                "rows": {f.name: getattr(rows, f.name)
                         for f in dataclasses.fields(RowState)},
                **schedule}, path)


def load_state(path: str, device, lr: float = 3e-4):
    """``(TrainState, RowState, schedule scalars)`` from the port's state
    file (``save_state``) or a JAX program's ``.pkl``
    (``utils.jax_state.load_jax_state``), on ``device``."""
    if not zipfile.is_zipfile(path):  # torch.save writes a zip archive
        return load_jax_state(path, device, lr)
    snap = torch.load(path, map_location="cpu", weights_only=True)
    if snap.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a curriculum state file")
    a, c = snap["actor"], snap["critic"]
    hidden, obs = a["fc1.weight"].shape
    actor = Actor(obs, hidden, a["fc_mu.weight"].shape[0])
    critic = Critic(obs, c["fc1.weight"].shape[1] // obs, hidden)
    opts = []
    for module, params, opt_state in ((actor, a, snap["actor_opt"]),
                                      (critic, c, snap["critic_opt"])):
        module.load_state_dict(params)
        module.to(device)
        opt = make_adam(module, lr)
        restore_adam(opt, opt_state)
        opts.append(opt)
    rows = RowState(*(snap["rows"][f.name].to(device)
                      for f in dataclasses.fields(RowState)))
    schedule = {k: snap[k] for k in SCHEDULE_KEYS if k in snap}
    return TrainState(actor, critic, *opts), rows, schedule


# ----------------------------------------------------------------------
# A stage
# ----------------------------------------------------------------------

def stage_functions(cfg: MAPPOConfig, ep: EnvParams, icfg, device):
    """The stage's MAPPO bundle and fused collect, on ``device``."""
    norm, scal = NormalizerConfig(), ScalerConfig()
    mappo = make_mappo(cfg, make_env(ep, icfg, device), norm, scal,
                       uncollapsed_actor(cfg, True), tiled_route(cfg, True))
    return mappo, make_fused_collect(cfg, ep, icfg, norm, scal)


def run_repeats(mappo, collect, ts: TrainState, rows: RowState, n: int,
                base_seed: int, gr: int, device: torch.device):
    """``n`` repeats (collect -> actor phase -> critic phase) from the
    run's repeat ``gr``, in blocks of ``BLOCK``; returns ``(rows, (n, 4 +
    2L) block rows)`` (``train.pack_block``), read once a block.  On the
    card every full block after the first replays one repeat's graph."""
    seeds = torch.zeros(BLOCK, dtype=torch.int32, device=device)
    offsets = torch.arange(BLOCK, dtype=torch.int32, device=device)
    blocks = _Blocks(mappo, ts, None,
                     lambda ts_, rows_, i: collect(ts_, rows_, seeds[i]),
                     seeds, offsets, base_seed, BLOCK, pipeline=True)
    out, done, warmed = [], 0, False
    while done < n:
        size = min(BLOCK, n - done)
        if size == BLOCK and warmed and device.type == "cuda":
            rows, packed = blocks.graphed(rows, gr + done)
        else:
            rows, packed = blocks.eager(rows, gr + done, size)
            warmed = warmed or size == BLOCK
        out.append(packed.cpu().numpy())  # the block's one read
        done += size
    return rows, np.concatenate(out)


def mean_eval(ep: EnvParams, icfg, t: int, rows: RowState, actor: Actor,
              tf: float, device) -> int:
    """Group reaches of one policy-mean rollout of ``t`` steps from the
    live rows: the steps whose reward carries the target bonus (every
    other term is O(1e3) at these factors)."""
    roll = make_fused_rollout(ep, icfg, NormalizerConfig(), ScalerConfig(),
                              t, deterministic_actions=True, device=device)
    _, rewards = roll(rows, actor, 0)
    return int((rewards > tf / 2.0).sum())


def _start(mappo, seed: int, device):
    """A fresh train state and its env rows."""
    ts, es = mappo.init(make_generator(seed, device))
    return ts, env_state_to_rows(es)


def _check_rows(rows: RowState, p: int, path: str) -> None:
    if rows.px.shape[-1] != p:
        raise ValueError(f"{path} holds {rows.px.shape[-1]} envs; this mode "
                         f"runs {p}")


def run_adaptive(ns, p: int = P_ADAPTIVE, t: int = T_ADAPTIVE):
    """``--mode radius-adaptive``: shrink the radius 15% while the stage's
    last-quarter group-reach share exceeds 2%."""
    dev = resolve_device(ns.device)
    icfg = TriangleInitConfig(num_parallel=p, num_obstacles=3)
    cfg = build_cfg(p, t, ent_const=1e-2)
    base_seed = (ns.seed * 1_000_003) % (1 << 30)
    ts = rows = None
    gr, radius, stage, history = 0, 300.0, 0, []
    while radius >= REFERENCE_RADIUS and stage < ns.max_stages:
        stage += 1
        ep = EnvParams(num_parallel=p, risk_factor=ns.risk,
                       target_factor=500_000.0, target_radius=radius,
                       staggered_resets=True)
        mappo, collect = stage_functions(cfg, ep, icfg, dev)
        if ts is None:
            ts, rows = _start(mappo, ns.seed, dev)
        t0 = time.perf_counter()
        rows, packed = run_repeats(mappo, collect, ts, rows,
                                   ns.repeats_per_stage, base_seed, gr, dev)
        gr += ns.repeats_per_stage
        tar, col, trunc = quarter_counts(packed)
        share = share_of(tar, col, trunc)
        rec = {"stage": stage, "radius": radius, "tar": tar,
               "tar_share": round(share, 4), "col": col, "trunc": trunc,
               "seconds": round(time.perf_counter() - t0, 1)}
        history.append(rec)
        print(json.dumps(rec), flush=True)
        # Every stage's actor: training continues past the best stage.
        save_actor(f"{ns.out}_actor_stage{stage}.npz", ts.actor)
        radius = adaptive_gate(radius, share)
    path = f"{ns.out}_radius_adaptive.json"
    with open(path, "w") as f:
        json.dump(history, f, indent=2)
    print("wrote", path, flush=True)
    return history


def run_noise_adaptive(ns, p: int = P_ADAPTIVE, t: int = T_ADAPTIVE):
    """``--mode radius-noise-adaptive``: each anneal also halves the
    entropy bonus and shifts the variance head's bias; a collapse restores
    the last good state (``noise_adaptive_gate``)."""
    dev = resolve_device(ns.device)
    icfg = TriangleInitConfig(num_parallel=p, num_obstacles=3)
    base_seed = (ns.seed * 1_000_003) % (1 << 30)
    ts = rows = best = None
    gr, history = 0, []
    sched = Schedule()
    if ns.resume_state:
        ts, rows, saved = load_state(ns.resume_state, dev)
        _check_rows(rows, p, ns.resume_state)
        gr = saved["gr"]
        sched = resumed_schedule(saved)
        if ns.resume_var_shift:  # one-time, at resume
            shift_variance(ts.actor, ns.resume_var_shift)
        best = Snapshot.take(ts, rows)
        print(json.dumps({"resumed": {"from": ns.resume_state,
                                      "radius": sched.radius,
                                      "ent": sched.ent, "stage": sched.stage,
                                      "var_shift": ns.resume_var_shift}}),
              flush=True)
    while sched.radius >= REFERENCE_RADIUS and sched.stage < ns.max_stages:
        sched = dataclasses.replace(sched, stage=sched.stage + 1)
        radius, ent, stage = sched.radius, sched.ent, sched.stage
        tf, ep_len, gsf = stage_params(radius, ns)
        ep = EnvParams(num_parallel=p, risk_factor=ns.risk, target_factor=tf,
                       target_radius=radius, group_soft_factor=gsf,
                       episode_len=ep_len, staggered_resets=True)
        mappo, collect = stage_functions(build_cfg(p, t, ent_const=ent), ep,
                                         icfg, dev)
        if ts is None:
            ts, rows = _start(mappo, ns.seed, dev)
        t0 = time.perf_counter()
        rows, packed = run_repeats(mappo, collect, ts, rows,
                                   ns.repeats_per_stage, base_seed, gr, dev)
        gr += ns.repeats_per_stage
        tar, col, trunc = quarter_counts(packed)
        share = share_of(tar, col, trunc)
        rec = {"stage": stage, "radius": radius, "ent_const": ent,
               "target_factor": tf, "episode_len": ep_len,
               "var_bias_mean": round(
                   float(ts.actor.fc_var.bias.detach().mean()), 3),
               "tar": tar, "tar_share": round(share, 4), "col": col,
               "trunc": trunc,
               "seconds": round(time.perf_counter() - t0, 1)}
        if ns.mean_eval:
            rec["mean_tar"] = mean_eval(ep, icfg, t, rows, ts.actor, tf, dev)
        history.append(rec)
        print(json.dumps(rec), flush=True)
        save_actor(f"{ns.out}_actor_stage{stage}.npz", ts.actor)
        gate = noise_adaptive_gate(sched, tar, col, trunc, ns)
        if gate.cleared:
            best = Snapshot.take(ts, rows)
            if ns.save_state:
                save_state(ns.save_state, ts, rows, radius=radius, ent=ent,
                           gr=gr, stage=stage, share=share)
        if gate.var_shift:
            shift_variance(ts.actor, gate.var_shift)
        if gate.restored is not None:
            best.restore(ts, rows)
            if ns.restore_reheat:  # the snapshot stays as it was
                shift_variance(ts.actor, ns.restore_reheat)
            rec["restored"] = gate.restored
        for line in gate.lines:
            print(json.dumps(line), flush=True)
        sched = gate.schedule
        if gate.solved:
            break
    path = f"{ns.out}_radius_noise_adaptive.json"
    with open(path, "w") as f:
        json.dump(history, f, indent=2)
    print("wrote", path, flush=True)
    return history


def run_fixed(ns, p: int = P, t: int = T):
    """``--mode obstacles | radius | none``: the stages of
    ``stage_geometry``, each scored on its last quarter."""
    dev = resolve_device(ns.device)
    cfg = build_cfg(p, t)
    base_seed = (ns.seed * 1_000_003) % (1 << 30)
    # The update phases are stage-invariant: one bundle for every stage.
    env0 = EnvParams(num_parallel=p, risk_factor=ns.risk,
                     staggered_resets=True)
    icfg0 = TriangleInitConfig(num_parallel=p, num_obstacles=3)
    mappo, _ = stage_functions(cfg, env0, icfg0, dev)
    ts, rows = _start(mappo, ns.seed, dev)
    results, gr = [], 0
    for label, ep_over, init_over in stage_geometry(ns.mode):
        ep = EnvParams(num_parallel=p, risk_factor=ns.risk,
                       staggered_resets=True, **ep_over)
        icfg = TriangleInitConfig(num_parallel=p, num_obstacles=3,
                                  **init_over)
        collect = make_fused_collect(cfg, ep, icfg, NormalizerConfig(),
                                     ScalerConfig())
        t0 = time.perf_counter()
        rows, packed = run_repeats(mappo, collect, ts, rows,
                                   ns.repeats_per_stage, base_seed, gr, dev)
        dt = time.perf_counter() - t0
        gr += ns.repeats_per_stage
        q = max(1, ns.repeats_per_stage // 4)
        tar, col, trunc = (float(packed[-q:, k].sum()) for k in (3, 2, 1))
        endings = tar + col + trunc
        cell = {
            "stage": label,
            "mean_rew_first": float(packed[0, 0]),
            "mean_rew_last": float(np.mean(packed[-q:, 0])),
            "tar": tar, "col": col, "trunc": trunc,
            "tar_share": tar / endings if endings else 0.0,
            "col_share": col / endings if endings else 0.0,
            "seconds": dt,
        }
        results.append(cell)
        print(json.dumps(cell), flush=True)
    payload = {"mode": ns.mode, "risk": ns.risk,
               "repeats_per_stage": ns.repeats_per_stage, "stages": results}
    path = f"{ns.out}_{ns.mode}.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", path, flush=True)
    return payload


def build_parser() -> argparse.ArgumentParser:
    """scripts/curriculum.py's flags and defaults, ``--out`` under
    ``runs/``, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog="python -m marlnav_tpu_torch.scripts.curriculum",
        description=__doc__.splitlines()[0])
    ap.add_argument("--repeats-per-stage", type=int, default=300)
    ap.add_argument("--mode", type=str, default="obstacles",
                    choices=["obstacles", "radius", "radius-adaptive",
                             "radius-noise-adaptive", "none"])
    ap.add_argument("--risk", type=float, default=250.0)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--max-stages", type=int, default=14,
                    help="radius-adaptive: total stage budget")
    ap.add_argument("--ent-floor", type=float, default=5e-4,
                    help="radius-noise-adaptive: entropy-bonus floor")
    ap.add_argument("--bonus-scale", action="store_true",
                    help="radius-noise-adaptive: scale the group bonus "
                         "~1/radius (measured harmful; kept for the "
                         "record)")
    ap.add_argument("--coarse-threshold", type=float, default=0.02,
                    help="radius-noise-adaptive: anneal threshold above "
                         "radius 200")
    ap.add_argument("--fine-threshold", type=float, default=0.006,
                    help="radius-noise-adaptive: anneal threshold below "
                         "radius 200 (restore-on-collapse is the safety "
                         "net for over-eager anneals)")
    ap.add_argument("--var-shift", type=float, default=-0.5,
                    help="radius-noise-adaptive: variance-head bias shift "
                         "applied at each radius anneal")
    ap.add_argument("--group-soft", type=float, default=0.0,
                    help="radius-noise-adaptive: group-convergence "
                         "shaping factor (EnvParams.group_soft_factor)")
    ap.add_argument("--group-soft-radius", type=float, default=1e9,
                    help="apply --group-soft only at radius <= this")
    ap.add_argument("--episode-len-small", type=int, default=0,
                    help="radius-noise-adaptive: truncation horizon at "
                         "small radii (0 = keep 200 everywhere)")
    ap.add_argument("--episode-len-radius", type=float, default=150.0,
                    help="radius threshold for --episode-len-small")
    ap.add_argument("--mean-eval", action="store_true",
                    help="radius-noise-adaptive: per-stage mean-action "
                         "rollout, reporting group-reach events "
                         "(mean_tar)")
    ap.add_argument("--save-state", type=str, default="",
                    help="radius-noise-adaptive: save the full train state "
                         "(+ env rows + schedule position) at every good "
                         "anneal, for --resume-state (the port's own "
                         "torch.save file)")
    ap.add_argument("--resume-state", type=str, default="",
                    help="radius-noise-adaptive: resume a cascade from a "
                         "--save-state file of either package")
    ap.add_argument("--resume-var-shift", type=float, default=0.0,
                    help="radius-noise-adaptive: one-time variance-head "
                         "bias shift applied at --resume-state (negative "
                         "= colder sampling)")
    ap.add_argument("--restore-reheat", type=float, default=0.0,
                    help="radius-noise-adaptive: variance-head bias bump "
                         "applied on every restore-on-collapse")
    ap.add_argument("--consolidate", type=int, default=1,
                    help="radius-noise-adaptive: number of CONSECUTIVE "
                         "gate-clearing stages required AT the reference "
                         "radius 30 before declaring solved")
    ap.add_argument("--out", type=str, default="runs/curriculum_r2")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: cuda; raises "
                         "without a card; cpu runs the kernels' plain "
                         "PyTorch versions)")
    return ap


def main(argv=None, p: Optional[int] = None, t: Optional[int] = None):
    """Run the curriculum of ``argv``; ``p`` envs and ``t`` steps a repeat
    where given (tests), else the mode's.  Returns what the mode wrote."""
    ns = build_parser().parse_args(argv)
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    run, sizes = {"radius-adaptive": (run_adaptive, (P_ADAPTIVE, T_ADAPTIVE)),
                  "radius-noise-adaptive": (run_noise_adaptive,
                                            (P_ADAPTIVE, T_ADAPTIVE))
                  }.get(ns.mode, (run_fixed, (P, T)))
    return run(ns, p or sizes[0], t or sizes[1])


if __name__ == "__main__":
    main()
