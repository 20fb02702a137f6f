"""Reward-factor sweep: one training run a cell, scored by how its
episodes end.

Port of ``scripts/sweep.py``.  Same grids (``main``, ``quick``,
``target``), cell arguments and outputs (``<out>.json``, and ``<out>.md``
for ``main`` and ``quick``), plus ``--device`` (default ``cuda``; raises
without a card unless ``--device cpu``); the default ``--out`` lies
under ``runs/``.

Each cell trains the GAE configuration (2048 envs, buffer 200, 10 + 10
epochs, lr 3e-4, gamma 0.99, epsilon 0.2, staggered resets, fixed
semantics, fused collect and fused updates) for ``--repeats`` repeats
through ``train.train(cfg, device, fused_collect=True, jit_repeats=50)``:
blocks of 50 repeats, CUDA graphs on the card.  The last quarter of the
repeats is scored by its episode endings (``logger.logs["epi_stats"]``):
group target reaches against collisions against truncations.  The
artifacts a cell writes go to a temporary directory.

Usage: python -m marlnav_tpu_torch.scripts.sweep [--repeats 300]
       [--grid main|quick|target] [--out runs/sweep_r2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from marlnav_tpu_torch.__main__ import build_parser as cli_parser
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.train import train

QUICK = [(0.0, 500.0, 1e-3, 500.0), (250.0, 500.0, 1e-3, 500.0)]
# The risk axis (the collision-penalty lever) crossed with the default
# shaping, plus weaker heading shaping and more exploration.
MAIN = [
    (0.0, 500.0, 1e-3, 500.0),  # baseline (reference defaults)
    (100.0, 500.0, 1e-3, 500.0),
    (250.0, 500.0, 1e-3, 500.0),
    (500.0, 500.0, 1e-3, 500.0),
    (1000.0, 500.0, 1e-3, 500.0),
    (250.0, 100.0, 1e-3, 500.0),
    (500.0, 100.0, 1e-3, 500.0),
    (250.0, 500.0, 1e-2, 500.0),
]
# The group-target bonus made the dominant term: (risk, heading, ent, soft,
# target).
TARGET = [
    (250.0, 500.0, 1e-3, 500.0, 50_000.0),
    (0.0, 500.0, 1e-3, 500.0, 50_000.0),
    (250.0, 100.0, 1e-3, 100.0, 50_000.0),
    (500.0, 500.0, 1e-2, 500.0, 200_000.0),
]


def run_cell(risk, heading, ent, soft, repeats, seed=13, jit_repeats=50,
             target=500.0, device="cuda", p=2048, t=200):
    """Train one cell for ``repeats`` repeats of ``p`` envs x ``t`` steps
    and score its last quarter."""
    args = cli_parser().parse_args([
        "-np", str(p), "-bl", str(t), "-bs", str(t), "-ne", "10",
        "-nt", str(repeats * t * p), "-lr", "0.0003", "-g", "0.99",
        "-ep", "0.2", "-se", str(seed),
        "-rf", str(risk), "-hf", str(heading), "-ec", str(ent),
        "-sf", str(soft), "-tf", str(target),
        "--use-gae", "--fixed-semantics", "--staggered-resets",
        "--fused-collect", "--fused-updates",
    ])
    cfg = resolve_run_config(args)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, _, logger = train(cfg, device=device, fused_collect=True,
                             output_root=tmp, verbose=False,
                             jit_repeats=jit_repeats)
        dt = time.perf_counter() - t0
    logs = logger.logs
    tail = slice(-max(1, repeats // 4), None)  # the last quarter
    stats = logs["epi_stats"]
    tar = float(np.sum(stats["tar"][tail]))
    col = float(np.sum(stats["col"][tail]))
    trunc = float(np.sum(stats["trunc"][tail]))
    endings = tar + col + trunc
    return {
        "risk_factor": risk, "heading_factor": heading, "ent_const": ent,
        "soft_factor": soft,
        "mean_rew_first": float(logs["mean_rews"][0]),
        "mean_rew_last": float(np.mean(logs["mean_rews"][tail])),
        "tar": tar, "col": col, "trunc": trunc,
        "tar_share": tar / endings if endings else 0.0,
        "col_share": col / endings if endings else 0.0,
        "seconds": dt,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m marlnav_tpu_torch.scripts.sweep",
        description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--out", type=str, default="runs/sweep_r2")
    ap.add_argument("--grid", type=str, default="main",
                    choices=["main", "quick", "target"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: cuda; raises "
                         "without a card)")
    return ap


def _write_json(out: str, repeats: int, rows) -> None:
    with open(out + ".json", "w") as f:
        json.dump({"repeats": repeats, "cells": rows}, f, indent=2)


def main(argv=None, p: int = 2048, t: int = 200):
    """Run the grid of ``argv`` (cells of ``p`` envs x ``t`` steps; tests
    pass small ones); returns the cells, best reach share first."""
    ns = build_parser().parse_args(argv)
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    rows = []
    if ns.grid == "target":
        for i, (r, h, e, so, tf) in enumerate(TARGET):
            print(f"[{i + 1}/{len(TARGET)}] risk={r} heading={h} ent={e} "
                  f"soft={so} target={tf} ...", flush=True)
            cell = run_cell(r, h, e, so, ns.repeats, target=tf,
                            device=ns.device, p=p, t=t)
            cell["target_factor"] = tf
            rows.append(cell)
            print(json.dumps(cell), flush=True)
        rows.sort(key=lambda c: -c["tar_share"])
        _write_json(ns.out, ns.repeats, rows)
        print("wrote", ns.out + ".json", flush=True)
        return rows

    grid = QUICK if ns.grid == "quick" else MAIN
    for i, (r, h, e, s) in enumerate(grid):
        print(f"[{i + 1}/{len(grid)}] risk={r} heading={h} ent={e} ...",
              flush=True)
        cell = run_cell(r, h, e, s, ns.repeats, device=ns.device, p=p, t=t)
        rows.append(cell)
        print(json.dumps(cell), flush=True)
    rows.sort(key=lambda c: -c["tar_share"])
    _write_json(ns.out, ns.repeats, rows)

    lines = [
        "# Reward-factor sweep",
        "",
        f"GAE config ({p} envs x buffer {t}, 10+10 epochs, lr 3e-4, "
        f"gamma 0.99), {ns.repeats} repeats per cell "
        f"({ns.repeats * t * p / 1e6:.0f}M env-steps), fused collect "
        f"+ fused updates on {ns.device}.  Scored on the last quarter of "
        "training; `tar/col/trunc share` = fraction of episode endings.",
        "",
        "| risk | heading | ent | mean_rew(last) | tar% | col% | trunc% "
        "| secs |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in rows:
        endings = c["tar"] + c["col"] + c["trunc"]
        lines.append(
            f"| {c['risk_factor']:.0f} | {c['heading_factor']:.0f} "
            f"| {c['ent_const']:g} | {c['mean_rew_last']:.0f} "
            f"| {100 * c['tar_share']:.1f} | {100 * c['col_share']:.1f} "
            f"| {100 * c['trunc'] / endings if endings else 0:.1f} "
            f"| {c['seconds']:.0f} |")
    with open(ns.out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {ns.out}.md / .json", flush=True)
    return rows


if __name__ == "__main__":
    main()
