"""Hold the port's training against the JAX package's recorded runs, in
distribution.

The two packages draw different initial weights and env streams, so a run
of the port is a new draw from the training's distribution, not a replay:
only distributions can match.  Four checks, each through the port's own
curriculum programs (``scripts/curriculum.py``, ``scripts/sweep.py``),
each against the JAX package's records under ``docs/`` (read from their
JSON files, never copied):

* ``ignition``: the first stage from scratch (radius 300) for each of the
  16 seeds the JAX records hold a first stage of (``SEEDS``), with the
  JAX run's flags (``docs/curriculum_r5.md:254``): ``--mode
  radius-noise-adaptive --repeats-per-stage 600 --group-soft 50000
  --episode-len-small 400 --max-stages 1`` at 4096 envs x 200 steps.
  Per seed: ``tar_share``, ``var_bias_mean``, ``tar``, ``col``,
  ``trunc``, seconds.  The port's values against the JAX package's by a
  two-sided Mann-Whitney U test (``mann_whitney``) on the share of group
  reaches (recomputed from the counts on both sides) and on
  ``var_bias_mean``, and the count of seeds at 1% or more; again without
  seeds 5 and 42, whose JAX runs took the pre-bounded-trig physics.
  Passes when both p >= 0.05 and 1-8 of 16 seeds reach 1%.
* ``ignition-jax-init``: the same, each seed starting from the JAX
  package's initial weights, ``mappo.init(jax.random.PRNGKey(seed))``,
  from ``jax_init_weights.npz`` beside this file (written by
  ``tests/test_torch_hold.py``), copied in after the curriculum's
  ``_start`` (``jax_initial_weights``).  If ``ignition`` differs from the
  JAX spread and this does not, the initial draw is at fault; if both
  differ, the training step.
* ``h42``: H42 in full, 20 stages resumed from
  ``docs/curriculum_r5s42_state.pkl`` with the run's flags
  (``docs/curriculum_r5.md:268``), stage by stage beside
  ``docs/curriculum_r5s42b_radius_noise_adaptive.json``.  Passes when
  stages 32-37 hold 4% each or more and the run clears the 1% gate at
  radius 30 on 6 stages or more.
* ``sweep``: ``sweep --grid main`` (300 repeats a cell) beside
  ``docs/sweep_r2.json``.  Passes when every cell ends 95% or more of its
  episodes in collisions and ``mean_rew_last`` falls over risk at
  heading 500 (entropy 1e-3) in the JAX record's order.  ``--sweep-seeds``
  runs each cell at more seeds too, for its spread (the rule reads seed
  13, the record's).

Usage: python -m marlnav_tpu_torch.scripts.hold
       [--check ignition|ignition-jax-init|h42|sweep|all] [--out runs/hold]
       [--device cuda|cpu] [--seeds 2,3,...] [--repeats-per-stage 600]
       [--stages 20] [--grid main|quick] [--sweep-repeats 300]
       [--sweep-seeds 1,2,...] [--updates fused|autograd]

writes ``<out>/hold.json`` (the curriculum and sweep runs write their own
files under ``<out>``).  The defaults are the full checks; the smaller
values of those flags are cuts, named in the JSON.  ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs the
kernels' plain PyTorch versions (tests pass ``p`` and ``t`` to ``main``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from marlnav_tpu_torch.models.networks import load_flat_params
from marlnav_tpu_torch.scripts import curriculum as cur
from marlnav_tpu_torch.scripts import sweep as swp
from marlnav_tpu_torch.utils.seeding import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOCS = os.path.join(ROOT, "docs")
JAX_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "jax_init_weights.npz")
# The seeds whose first stage the JAX records hold at these flags: the
# chained runs (curriculum_r5s<seed>) and the screen
# (curriculum_r5screen_s<seed>).
SEEDS = (2, 3, 5, 7, 11, 13, 19, 29, 31, 37, 41, 42, 43, 47, 53, 59)
PRE_TRIG = (5, 42)  # run on the pre-bounded-trig physics
IGNITION = ["--mode", "radius-noise-adaptive", "--repeats-per-stage", "600",
            "--group-soft", "50000", "--episode-len-small", "400",
            "--max-stages", "1"]
H42 = ["--mode", "radius-noise-adaptive", "--seed", "42",
       "--repeats-per-stage", "600", "--group-soft", "50000",
       "--episode-len-small", "400", "--mean-eval", "--coarse-threshold",
       "0.01", "--fine-threshold", "0.01", "--consolidate", "20",
       "--resume-state", os.path.join(DOCS, "curriculum_r5s42_state.pkl")]
H42_RECORD = os.path.join(DOCS,
                          "curriculum_r5s42b_radius_noise_adaptive.json")
SWEEP_RECORD = os.path.join(DOCS, "sweep_r2.json")
CHECKS = ("ignition", "ignition-jax-init", "h42", "sweep")
STAGE_FIELDS = ("tar_share", "var_bias_mean", "tar", "col", "trunc",
                "seconds")


# ----------------------------------------------------------------------
# Statistics
# ----------------------------------------------------------------------

def mann_whitney(x: Sequence[float], y: Sequence[float]) -> Dict[str, float]:
    """Two-sided Mann-Whitney U test of samples ``x`` and ``y``: ``{"u":
    U of x, "p": p-value}``, by the normal approximation with the tie
    correction and a continuity correction of 1/2 (what
    ``scipy.stats.mannwhitneyu(x, y, method="asymptotic")`` computes).
    Ties take the mean of their ranks."""
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    n1, n2 = x.size, y.size
    both = np.concatenate([x, y])
    order = np.argsort(both, kind="mergesort")
    ranks = np.empty(both.size)
    sorted_ = both[order]
    i = 0
    while i < both.size:  # runs of equal values share their mean rank
        j = i
        while j + 1 < both.size and sorted_[j + 1] == sorted_[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    u1 = ranks[:n1].sum() - n1 * (n1 + 1) / 2.0
    n = n1 + n2
    _, counts = np.unique(both, return_counts=True)
    ties = float(np.sum(counts ** 3 - counts))
    var = n1 * n2 / 12.0 * ((n + 1) - ties / (n * (n - 1)))
    u = max(u1, n1 * n2 - u1)
    if var <= 0.0:  # every value equal
        return {"u": float(u1), "p": 1.0}
    z = (u - n1 * n2 / 2.0 - 0.5) / math.sqrt(var)
    return {"u": float(u1), "p": min(1.0, math.erfc(z / math.sqrt(2.0)))}


def reach_share(rec: dict) -> float:
    """Group reaches over all episode endings, from a stage's counts (the
    records' ``tar_share`` is rounded to 4 places)."""
    return cur.share_of(int(rec["tar"]), int(rec["col"]), int(rec["trunc"]))


# ----------------------------------------------------------------------
# The JAX package's records
# ----------------------------------------------------------------------

def jax_first_stage(seed: int) -> dict:
    """The JAX record of ``seed``'s first stage: the chained run's file,
    else the screen's."""
    for name in (f"curriculum_r5s{seed}_radius_noise_adaptive.json",
                 f"curriculum_r5screen_s{seed}_radius_noise_adaptive.json"):
        path = os.path.join(DOCS, name)
        if os.path.exists(path):
            with open(path) as fh:
                first = json.load(fh)[0]
            if first["stage"] != 1:
                raise ValueError(f"{path}: first record is stage "
                                 f"{first['stage']}, not 1")
            return first
    raise FileNotFoundError(f"no JAX record of seed {seed}'s first stage "
                            f"under {DOCS}")


def load_jax_init(path: str = JAX_INIT) -> Dict[int, dict]:
    """``{seed: {"actor": flat, "critic": flat}}`` from the ``.npz`` of the
    JAX package's initial weights: keys ``<seed>/<net>/<layer>.<w|b>``,
    each in the ``.npz`` weight-file layout (``fc1.w`` (in, out))."""
    table: Dict[int, dict] = {}
    with np.load(path) as data:
        for key in data.files:
            seed, net, leaf = key.split("/")
            table.setdefault(int(seed), {}).setdefault(net, {})[leaf] = \
                data[key]
    return table


@contextlib.contextmanager
def jax_initial_weights(table: Dict[int, dict]):
    """Within the block, the curriculum's ``_start`` copies seed ``s``'s
    JAX initial weights (``table[s]``) into the networks ``mappo.init``
    made; the env rows and Adam's fresh state stay the port's."""
    start = cur._start

    def _start(mappo, seed, device):
        ts, rows = start(mappo, seed, device)
        load_flat_params(ts.actor, table[seed]["actor"])
        load_flat_params(ts.critic, table[seed]["critic"])
        return ts, rows

    cur._start = _start
    try:
        yield
    finally:
        cur._start = start


@contextlib.contextmanager
def autograd_updates():
    """Within the block, the curriculum's and the sweep's runs train their
    update phases through autograd instead of the fused update kernels (the
    collect kernel stays): where a check fails, this run of it tells the
    kernels from the rest."""
    build, resolve = cur.build_cfg, swp.resolve_run_config

    def build_cfg(*args, **kw):
        return dataclasses.replace(build(*args, **kw), fused_updates=False)

    def resolve_run_config(args):
        cfg = resolve(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_updates=False))

    cur.build_cfg, swp.resolve_run_config = build_cfg, resolve_run_config
    try:
        yield
    finally:
        cur.build_cfg, swp.resolve_run_config = build, resolve


# ----------------------------------------------------------------------
# The checks
# ----------------------------------------------------------------------

def compare_seeds(port: Dict[int, dict], jax: Dict[int, dict]) -> dict:
    """Mann-Whitney U of the reach share and of ``var_bias_mean``, and the
    seeds at 1% or more, of ``port`` against ``jax`` (stage records by
    seed)."""
    def side(recs):
        return ([reach_share(r) for r in recs.values()],
                [float(r["var_bias_mean"]) for r in recs.values()])

    ps, pv = side(port)
    js, jv = side(jax)
    return {"seeds": len(port), "jax_seeds": len(jax),
            "tar_share": mann_whitney(ps, js),
            "var_bias_mean": mann_whitney(pv, jv),
            "ge_1pct": sum(s >= 0.01 for s in ps),
            "jax_ge_1pct": sum(s >= 0.01 for s in js)}


def ignition(ns, out: str, jax_init: bool, p: Optional[int],
             t: Optional[int]) -> dict:
    """Check ``ignition`` (or, with ``jax_init``, ``ignition-jax-init``)."""
    tag = "ignition_jax_init" if jax_init else "ignition"
    seeds = ns.seeds
    jax = {s: jax_first_stage(s) for s in SEEDS}
    port = {}
    ctx = (jax_initial_weights(load_jax_init()) if jax_init
           else contextlib.nullcontext())
    with ctx:
        for s in seeds:
            t0 = time.perf_counter()
            hist = cur.main(IGNITION + [
                "--seed", str(s), "--repeats-per-stage",
                str(ns.repeats_per_stage), "--device", ns.device, "--out",
                os.path.join(out, f"{tag}_s{s}")], p, t)
            port[s] = {k: hist[0][k] for k in STAGE_FIELDS}
            port[s]["wall_s"] = time.perf_counter() - t0
            print(json.dumps({tag: {"seed": s, **port[s],
                                    "jax_tar_share": jax[s]["tar_share"]}}),
                  flush=True)
    tests = {"all": compare_seeds(port, jax),
             "without_5_42": compare_seeds(
                 {s: r for s, r in port.items() if s not in PRE_TRIG},
                 {s: r for s, r in jax.items() if s not in PRE_TRIG})}
    a = tests["all"]
    passed = (a["tar_share"]["p"] >= 0.05 and a["var_bias_mean"]["p"] >= 0.05
              and 1 <= a["ge_1pct"] <= 8)
    return {"port": port,
            "jax": {s: {k: jax[s][k] for k in STAGE_FIELDS} for s in SEEDS},
            "tests": tests, "passed": passed}


def h42(ns, out: str, t: Optional[int]) -> dict:
    """Check ``h42``: ``ns.stages`` stages of the H42 continuation."""
    with open(H42_RECORD) as fh:
        record = {r["stage"]: r for r in json.load(fh)}
    first = min(record)  # the state's own stage is first - 1
    hist = cur.main(H42 + ["--repeats-per-stage", str(ns.repeats_per_stage),
                           "--max-stages", str(first - 1 + ns.stages),
                           "--device", ns.device,
                           "--out", os.path.join(out, "h42")],
                    cur.P_ADAPTIVE, t)
    keys = ("stage", "radius", "tar_share", "tar", "col", "trunc",
            "mean_tar", "var_bias_mean", "seconds")
    stages = []
    for rec in hist:
        jax = record.get(rec["stage"], {})
        stages.append({**{k: rec[k] for k in keys},
                       "share": reach_share(rec),
                       "restored": rec.get("restored") is not None,
                       "jax_tar_share": jax.get("tar_share"),
                       "jax_mean_tar": jax.get("mean_tar"),
                       "jax_restored": jax.get("restored") is not None})

    def clears(recs):
        """Stages that clear the run's 1% gate at radius 30."""
        return sum(r["radius"] <= cur.REFERENCE_RADIUS
                   and reach_share(r) > 0.01 for r in recs)

    early = min(s["share"] for s in stages if s["stage"] < first + 6)
    return {"stages": stages, "min_share_first_6": early,
            "clears_at_30": clears(hist),
            "jax_clears_at_30": clears(record.values()),
            "passed": early >= 0.04 and clears(hist) >= 6}


def sweep(ns, out: str, p: Optional[int], t: Optional[int]) -> dict:
    """Check ``sweep``: the grid ``ns.grid`` beside ``docs/sweep_r2.json``."""
    with open(SWEEP_RECORD) as fh:
        jax_cells = json.load(fh)["cells"]

    def key(c):
        return (c["risk_factor"], c["heading_factor"], c["ent_const"],
                c["soft_factor"])

    jax = {key(c): c for c in jax_cells}
    sizes = {k: v for k, v in (("p", p), ("t", t)) if v}
    rows = swp.main(["--grid", ns.grid, "--repeats", str(ns.sweep_repeats),
                     "--device", ns.device,
                     "--out", os.path.join(out, f"sweep_{ns.grid}")],
                    **sizes)
    cells = []
    for c in rows:
        j = jax[key(c)]
        cells.append({"risk_factor": c["risk_factor"],
                      "heading_factor": c["heading_factor"],
                      "ent_const": c["ent_const"],
                      "soft_factor": c["soft_factor"],
                      **{k: c[k] for k in ("col_share", "tar_share",
                                           "mean_rew_first", "mean_rew_last",
                                           "seconds")},
                      "jax_col_share": j["col_share"],
                      "jax_mean_rew_last": j["mean_rew_last"]})

    def order(field):
        """The risks at heading 500, entropy 1e-3, by ``field``, highest
        first."""
        axis = [c for c in cells
                if c["heading_factor"] == 500.0 and c["ent_const"] == 1e-3]
        return [c["risk_factor"] for c in sorted(axis,
                                                 key=lambda c: -c[field])]

    by_port, by_jax = order("mean_rew_last"), order("jax_mean_rew_last")
    # The spread of each cell over more seeds (the record's is 13, the
    # rule's): where one seed's cells differ from the record, whether the
    # record lies inside the port's own spread.
    for c in cells:
        c["other_seeds"] = {
            seed: {k: cell[k] for k in ("col_share", "tar_share",
                                        "mean_rew_last")}
            for seed in ns.sweep_seeds
            for cell in [swp.run_cell(c["risk_factor"], c["heading_factor"],
                                      c["ent_const"], c["soft_factor"],
                                      ns.sweep_repeats, seed=seed,
                                      device=ns.device, **sizes)]}
    return {"cells": cells, "order_by_risk": by_port,
            "jax_order_by_risk": by_jax,
            "passed": (all(c["col_share"] >= 0.95 for c in cells)
                       and by_port == by_jax)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m marlnav_tpu_torch.scripts.hold",
        description=__doc__.splitlines()[0])
    ap.add_argument("--check", choices=CHECKS + ("all",), default="all")
    ap.add_argument("--out", default="runs/hold",
                    help="directory of hold.json and the runs' files")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                         "card; cpu runs the kernels' plain versions)")
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)),
                    help="ignition checks: the seeds to run (a cut below "
                         "the 16)")
    ap.add_argument("--repeats-per-stage", type=int, default=600,
                    help="ignition and h42 checks (a cut below 600)")
    ap.add_argument("--stages", type=int, default=20,
                    help="h42: stages from the state (a cut below 20)")
    ap.add_argument("--grid", choices=("main", "quick"), default="main",
                    help="sweep: the grid (quick is a cut)")
    ap.add_argument("--sweep-repeats", type=int, default=300,
                    help="sweep: repeats a cell (a cut below 300)")
    ap.add_argument("--sweep-seeds", default="",
                    help="sweep: more seeds to run each cell at beside the "
                         "record's 13, for the cells' spread (comma-"
                         "separated; none by default)")
    ap.add_argument("--updates", choices=("fused", "autograd"),
                    default="fused",
                    help="the update phases: the fused kernels (the "
                         "programs' own), or autograd (autograd_updates: "
                         "to tell the kernels from the rest where a check "
                         "fails)")
    return ap


def main(argv=None, p: Optional[int] = None, t: Optional[int] = None):
    """Run the checks of ``argv``; ``p`` envs (ignition, sweep; h42 keeps
    the state's) and ``t`` steps a repeat where given (tests).  Returns
    what ``<out>/hold.json`` holds."""
    ns = build_parser().parse_args(argv)
    resolve_device(ns.device)  # raises without a card
    ns.seeds = [int(s) for s in ns.seeds.split(",")]
    ns.sweep_seeds = [int(s) for s in ns.sweep_seeds.split(",") if s]
    unknown = sorted(set(ns.seeds) - set(SEEDS))
    if unknown:
        raise ValueError(f"no JAX record of seeds {unknown}; the seeds "
                         f"are {SEEDS}")
    os.makedirs(ns.out, exist_ok=True)
    checks = CHECKS if ns.check == "all" else (ns.check,)
    result = {"argv": list(argv) if argv is not None else None,
              "updates": ns.updates, "sizes": {"p": p, "t": t}, "cuts": {
                  "seeds": len(ns.seeds) < len(SEEDS),
                  "repeats_per_stage": ns.repeats_per_stage < 600,
                  "stages": ns.stages < 20, "grid": ns.grid != "main",
                  "sweep_repeats": ns.sweep_repeats < 300,
                  "sizes": p is not None or t is not None}}
    for check in checks:
        t0 = time.perf_counter()
        with (autograd_updates() if ns.updates == "autograd"
              else contextlib.nullcontext()):
            if check in ("ignition", "ignition-jax-init"):
                res = ignition(ns, ns.out, check == "ignition-jax-init", p,
                               t)
            elif check == "h42":
                res = h42(ns, ns.out, t)
            else:
                res = sweep(ns, ns.out, p, t)
        res["seconds"] = time.perf_counter() - t0
        result[check] = res
        print(json.dumps({check: {"passed": res["passed"],
                                  "seconds": res["seconds"]}}), flush=True)
    path = os.path.join(ns.out, "hold.json")
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1)
    print("wrote", path, flush=True)
    return result


if __name__ == "__main__":
    main()
