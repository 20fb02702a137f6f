"""Device timing of the port's kernels on one card, and a comparison of two
checkouts of the port in one process tree.

``cuda_ms`` times work by CUDA events, ``ptxas_summary`` reads a build
log's register and spill figures, ``step_case`` makes a step kernel's
inputs and ``training_repeat`` one full-size training repeat; the card
script (``chip_smoke.py``) uses them.

    git archive <commit> | tar -x -C archive_check/parent
    python3 -m marlnav_tpu_torch.timing archive_check/parent [--out DIR]

builds both checkouts' libraries at once, prints where their ``ptxas``
lines differ, then times the step kernels (``time_checkout``) in other,
this, this, other order, each in a process of its own that runs this file
on the other checkout's package (``PYTHONPATH`` and ``python -P``), and
prints each time and the ratio of the means.  The directory must be one
``.gitignore`` lists, so that the card's copy of the repo carries it.

So ``step_case``, ``training_repeat`` and ``time_checkout`` call only
entry points that both commits must have: ``config.EnvParams``,
``TriangleInitConfig``, ``NormalizerConfig``, ``ScalerConfig`` and
``resolve_run_config``; ``__main__.build_parser``; ``env.make_env``;
``models.Actor``; ``algo.make_mappo`` (``init``, ``train_many``);
``ops.fused_collect`` (``env_state_to_rows``, ``_affine_compose``,
``fused_collect_rows``, ``make_fused_collect``); ``ops.fused_rollout.
fused_rollout_rows``; ``ops.graphs.CountedGraph``; ``ops.step_math.
StepMath``; ``ops._build.load_libraries``; ``utils.seeding.
make_generator``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

import torch


def cuda_ms(fn, reps=1, warmup=0):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events.
    Each run is enqueued behind a ~5 ms spin of the device
    (``torch.cuda._sleep``), so the events time the device's work and not
    the host's gaps between a wrapper's launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_summary(log):
    """One line per kernel of a build log: its name and ptxas -v's
    register, stack and spill figures."""
    lines, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"  {entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def step_case(p, o=3, episode_len=200, noisy=False, tame=False, seed=0,
              device="cuda"):
    """``(step math, start rows, actor operator, its constant)`` of a step
    kernel over ``p`` envs with ``o`` obstacles: the env's initial state
    and a fresh 50-wide actor from ``seed``; ``tame`` shrinks the actor's
    mean and variance so that agents barely move."""
    from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                          ScalerConfig, TriangleInitConfig)
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops.step_math import StepMath
    from marlnav_tpu_torch.utils.seeding import make_generator

    ep = EnvParams(num_parallel=p, episode_len=episode_len, num_obstacles=o)
    ic = TriangleInitConfig(num_parallel=p, noisy_ags=noisy, num_obstacles=o)
    rows = fc.env_state_to_rows(make_env(ep, ic, device).init(
        make_generator(seed, device)))
    actor = Actor(ep.obs_size, 50,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    if tame:
        with torch.no_grad():
            actor.fc_mu.weight.mul_(1e-3)
            actor.fc_mu.bias.mul_(1e-3)
            actor.fc_var.bias.sub_(20.0)
    a_comp, c_comp = fc._affine_compose(actor)
    return (StepMath(ep, ic, NormalizerConfig(num_obstacles=o),
                     ScalerConfig()), rows, a_comp, c_comp)


def training_repeat(extra, out_dir, fused_updates=True, device="cuda"):
    """One training repeat at the CLI's defaults (1,024 envs, a buffer of
    1,000 steps) with ``--fused-updates`` and the flags ``extra``, the
    collect kernel's seed on the device (400), as a namespace: ``run()``
    runs the repeat in place; ``cfg``, ``collect``, ``mappo``, ``ts``,
    ``rows`` and ``seed`` are its parts.  ``fused_updates=False`` trains
    through autograd instead."""
    import dataclasses

    from marlnav_tpu_torch.__main__ import build_parser
    from marlnav_tpu_torch.algo import make_mappo
    from marlnav_tpu_torch.config import resolve_run_config
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.utils.seeding import make_generator

    cfg = resolve_run_config(build_parser().parse_args(
        ["-np", "1024", "-nt", str(1024 * 1000), "-se", "0",
         "--output-root", out_dir, "--fused-updates"] + list(extra)))
    mcfg = (cfg.model if fused_updates else
            dataclasses.replace(cfg.model, fused_updates=False))
    collect = fc.make_fused_collect(cfg.model, cfg.env, cfg.init,
                                    cfg.normalizer, cfg.scaler)
    mappo = make_mappo(mcfg, make_env(cfg.env, cfg.init, device),
                       cfg.normalizer, cfg.scaler, False, True)
    ts, state = mappo.init(make_generator(0, device))
    rows = fc.env_state_to_rows(state)
    seed = torch.tensor(400, dtype=torch.int32, device=device)
    run = (lambda: mappo.train_many(
        ts, rows, None, 1, lambda ts_, rows_, _: collect(ts_, rows_, seed)))
    return types.SimpleNamespace(run=run, cfg=cfg, collect=collect,
                                 mappo=mappo, ts=ts, rows=rows, seed=seed)


def time_checkout(out_dir):
    """{case: median ms} of the checkout whose package is imported: the
    collect at (envs, steps) (1024, 1000) and (16384, 200), the rollout at
    (16384, 500) in both modes, each at 3, 9, 17 and 32 obstacles with the
    library's own lane choice; and a ``-no 17`` repeat captured as a CUDA
    graph."""
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops import fused_rollout as fr
    from marlnav_tpu_torch.ops.graphs import CountedGraph

    res = {}
    for o in (3, 9, 17, 32):
        for p, t in ((1024, 1000), (16384, 200)):
            sm, rows, a, c = step_case(p, o)
            res[f"collect O={o} {p}x{t}"] = cuda_ms(
                lambda: fc.fused_collect_rows(sm, rows, a, c, 3, t), reps=7,
                warmup=2)
        sm, rows, a, c = step_case(16384, o)
        for det in (False, True):
            res[f"rollout {'mean' if det else 'sampled'} O={o} 16384x500"] = \
                cuda_ms(lambda: fr.fused_rollout_rows(sm, rows, a, c, 3, 500,
                                                      det), reps=7, warmup=2)
    rep = training_repeat(["-no", "17"], out_dir)
    rep.run()  # warm
    graph = CountedGraph()
    with graph.capture():
        rep.run()
    res["-no 17 graphed repeat"] = cuda_ms(graph.replay, reps=3, warmup=1)
    return res


def compare(other, out_dir):
    """Both checkouts' builds, their ptxas lines where they differ, and
    ``time_checkout`` of each (other, this, this, other), on one card;
    prints the times and the ratio other / this of their means."""
    if not torch.cuda.is_available():
        sys.exit("timing: torch.cuda.is_available() is False; this needs an "
                 "NVIDIA GPU")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")

    def start(root, *args):
        env = dict(os.environ, PYTHONPATH=root)
        return subprocess.Popen([sys.executable, "-P", __file__, *args],
                                cwd=root, env=env, stdout=subprocess.PIPE,
                                text=True)

    def result(proc):
        stdout, _ = proc.communicate()
        assert proc.returncode == 0, proc.returncode
        return json.loads(stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    logs = [result(proc) for proc in [start(root, "--build")
                                      for root in (other, here)]]
    print(f"both builds: {time.perf_counter() - t0:.1f} s")
    lines = []  # per build, {kernel: its ptxas figures}
    for log in logs:
        by_kernel = {}
        for name in sorted(log):
            for line in ptxas_summary(log[name]):
                kernel, figures = line.strip().split(": ", 1)
                by_kernel[kernel] = by_kernel.get(kernel, "") + figures + "; "
        lines.append(by_kernel)
    same = [k for k in lines[0] if lines[1].get(k) == lines[0][k]]
    print(f"ptxas lines equal in both builds: {len(same)} of "
          f"{len(lines[0])} (other) and {len(lines[1])} (this)")
    for k in sorted(set(lines[0]) | set(lines[1])):
        if k not in same:
            print(f"  {k}\n    other: {lines[0].get(k, '-')}\n    this:  "
                  f"{lines[1].get(k, '-')}")
    runs = []
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        runs.append((label, result(start(root, "--time", out_dir))))
        print(f"{label} ({root}): {json.dumps(runs[-1][1])}", flush=True)
    for key in runs[0][1]:
        o_ms = [r[key] for label, r in runs if label == "other"]
        t_ms = [r[key] for label, r in runs if label == "this"]
        print(f"{key}: other {o_ms[0]:.4f} / {o_ms[1]:.4f} ms, this "
              f"{t_ms[0]:.4f} / {t_ms[1]:.4f} ms: "
              f"{statistics.mean(o_ms) / statistics.mean(t_ms):.2f}x")
    print(f"card: {card}")


def _child(what, out_dir):
    """One step of ``compare`` in the checkout at the working directory:
    its build logs (``--build``) or its times (``--time``), one JSON
    line."""
    import marlnav_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(marlnav_tpu_torch.__file__)))
    if root != os.getcwd():
        sys.exit(f"timing: marlnav_tpu_torch imported from {root}, not from "
                 f"{os.getcwd()}")
    if what == "build":
        from marlnav_tpu_torch.ops._build import load_libraries

        builds = load_libraries(["fused_collect", "fused_rollout",
                                 "fused_update", "returns"])
        print(json.dumps({n: v[1]["log"] for n, v in builds.items()}))
    else:
        print(json.dumps(time_checkout(out_dir)))


if __name__ == "__main__":
    import contextlib
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", nargs="?", help="the other checkout's root")
    parser.add_argument("--out", help="directory for the training runs' "
                        "artifacts (default: a temporary one)")
    parser.add_argument("--build", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--time", metavar="OUT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.build or args.time:
        _child("build" if args.build else "time", args.time)
    elif not args.other:
        parser.error("give the other checkout's root")
    else:
        with contextlib.ExitStack() as stack:
            compare(args.other, args.out or stack.enter_context(
                tempfile.TemporaryDirectory()))
