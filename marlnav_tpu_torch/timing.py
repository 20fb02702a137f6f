"""Device timing of the port's kernels on one card, and a comparison of two
checkouts of the port in one process tree.

``cuda_ms`` times work by CUDA events, ``ptxas_summary`` reads a build
log's register and spill figures, ``step_case`` makes a step kernel's
inputs and ``training_repeat`` one full-size training repeat; the card
script (``chip_smoke.py``) uses them.

    git archive <commit> | tar -x -C archive_check/parent
    python3 -m marlnav_tpu_torch.timing archive_check/parent [--out DIR]
        [--group steps|grads]

builds both checkouts' libraries at once, prints where their ``ptxas``
lines differ, then times the step kernels (``time_checkout``) or the
tensor-core gradient kernels (``time_grads``) in other, this, this, other
order, each in a process of its own that runs this file on the other
checkout's package (``PYTHONPATH`` and ``python -P``), and prints each
time and the ratio of the means; with ``--group grads`` also each
checkout's outputs that miss the criterion (``within_reach``).  The directory must be one
``.gitignore`` lists, so that the card's copy of the repo carries it.

So what the children run calls only entry points that both commits
must have: ``config.EnvParams``,
``TriangleInitConfig``, ``NormalizerConfig``, ``ScalerConfig`` and
``resolve_run_config``; ``__main__.build_parser``; ``env.make_env``;
``models.Actor``, ``Critic``; ``algo.make_mappo`` (``init``,
``train_many``); ``algo.mappo.minibatch_slices``,
``minibatch_advantages``; ``ops.fused_update``'s three ``*_sums``
wrappers and ``ops.update_math``'s plain versions;
``scripts.curriculum.main``;
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


# The update kernels' outputs, in order, and the argument whose first
# dimension is the row count.
UPDATE_OUTPUTS = {
    "fused_actor_grad": ("loss", "dz", "dzs"),
    "fused_critic_grad": ("loss", "dW1", "db1", "dW2", "db2"),
    "fused_actor_grad_uncollapsed": (
        "loss", "dW1", "db1", "dWmu", "dbmu", "dWvar", "dbvar")}
ROWS_ARG = {"fused_actor_grad": 4, "fused_critic_grad": 4,
            "fused_actor_grad_uncollapsed": 6}
# The kernels whose products run on the tensor cores (tc_grad_kernel and
# the run-time-width route), and the criterion each of their outputs is
# held to: its error against float64 within REACH times the plain
# version's (float32, or bf16 in bf16 mode) or REACH_FLOOR of its
# tolerance (1e-4 of its largest magnitude, + 1e-7), whichever is larger.
TENSOR_CORE_WORK = ("fused_critic_grad", "fused_actor_grad_uncollapsed")
REACH, REACH_FLOOR = 4.0, 0.01
# The outputs the tensor cores sum (the backward's products, db1 as the
# ones row of [x | 1]^T g_pre in float32; bf16 sums db1 on the CUDA cores);
# the card script asserts the criterion on these for the templated
# instances and prints it for every output.
TENSOR_CORE_OUTPUTS = {
    ("fused_critic_grad", False): ("dW1", "db1"),
    ("fused_critic_grad", True): ("dW1",),
    ("fused_actor_grad_uncollapsed", False): ("dW1", "db1", "dWmu", "dWvar"),
    ("fused_actor_grad_uncollapsed", True): ("dW1", "dWmu", "dWvar")}


def update_functions():
    """{kernel name: (its wrapper, its plain PyTorch version)}."""
    from marlnav_tpu_torch.ops import fused_update as fu
    from marlnav_tpu_torch.ops import update_math as um

    return {"fused_actor_grad": (fu.actor_grad_sums,
                                 um.actor_grad_sums_reference),
            "fused_critic_grad": (fu.critic_grad_sums,
                                  um.critic_grad_sums_reference),
            "fused_actor_grad_uncollapsed": (
                fu.actor_grad_uncollapsed_sums,
                um.actor_grad_sums_uncollapsed_reference)}


def output_errors(kernel_outs, plain_outs, f64_outs, n):
    """Per output, ``(error of the kernel, error of the plain version,
    tolerance)``, each sum taken as a mean over its ``n`` rows (what Adam
    sees) against the float64 one; the tolerance 1e-4 of the float64
    mean's largest magnitude, + 1e-7."""
    res = []
    for k, q, w in zip(kernel_outs, plain_outs, f64_outs):
        w = w.double() / n
        res.append(((k.double() / n - w).abs().max().item(),
                    (q.double() / n - w).abs().max().item(),
                    1e-4 * w.abs().max().item() + 1e-7))
    return res


def within_reach(err, plain_err, tol):
    """Whether an output's error lies within the plain version's reach:
    REACH times its error, or REACH_FLOOR of the tolerance."""
    return err <= max(REACH * plain_err, REACH_FLOOR * tol)


def update_args(name, net, mb, cfg):
    """The arguments of update kernel ``name`` on minibatch ``mb`` (a
    ``Buffer`` slice) through ``net``: the actor for the actor kernels,
    the critic for the critic's."""
    from marlnav_tpu_torch.algo.mappo import minibatch_advantages
    from marlnav_tpu_torch.ops import fused_collect as fc

    if name == "fused_critic_grad":
        n = mb.returns.numel()
        return (net.fc1.weight.detach(), net.fc1.bias.detach(),
                net.fc2.weight.detach(), net.fc2.bias.detach(),
                mb.obs.reshape(n, -1), mb.values.reshape(n),
                mb.returns.reshape(n), cfg.epsilon)
    n = mb.log_probs.numel()
    weights = (fc._affine_compose(net) if name == "fused_actor_grad" else
               # parameters(): fc1, fc_mu, fc_var, each weight then bias.
               tuple(p_.detach() for p_ in net.parameters()))
    return (*weights, mb.obs.reshape(n, -1), mb.actions.reshape(n, -1),
            mb.log_probs.reshape(n), minibatch_advantages(mb, cfg),
            cfg.epsilon, cfg.ent_const)


def collected_batch(p, t, device="cuda"):
    """The update kernels' inputs of a real collect at (envs, steps) ``(p,
    t)``, default widths: the buffer the fused collect kernel fills from
    initial networks (seed 0), faithful full batch (T - 1 steps), and
    networks of another seed, whose ratios spread around 1 (some rows
    clipped) and whose values leave the old ones' band.  A namespace:
    ``cfg`` (the model config), ``ts`` (the collecting networks), ``buf``,
    ``mb`` (the full batch), ``actor`` and ``critic``."""
    from marlnav_tpu_torch.__main__ import build_parser
    from marlnav_tpu_torch.algo import make_mappo
    from marlnav_tpu_torch.algo.mappo import minibatch_slices
    from marlnav_tpu_torch.config import resolve_run_config
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.models import Actor, Critic
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.utils.seeding import make_generator

    scfg = resolve_run_config(build_parser().parse_args(
        ["-np", str(p), "-bl", str(t), "-bs", str(t), "-nt", str(p * t),
         "-se", "0"]))
    mcfg = scfg.model
    mappo = make_mappo(mcfg, make_env(scfg.env, scfg.init, device),
                       scfg.normalizer, scfg.scaler)
    ts, es = mappo.init(make_generator(1, device))
    _, buf, _ = fc.make_fused_collect(
        mcfg, scfg.env, scfg.init, scfg.normalizer, scfg.scaler)(
            ts, fc.env_state_to_rows(es), 7)
    g = torch.Generator().manual_seed(2)
    actor = Actor(mcfg.obs_size, mcfg.hidden_size, generator=g).to(device)
    critic = Critic(mcfg.obs_size, mcfg.num_agents, mcfg.hidden_size,
                    generator=g).to(device)
    return types.SimpleNamespace(cfg=mcfg, ts=ts, buf=buf,
                                 mb=minibatch_slices(buf, mcfg)[0],
                                 actor=actor, critic=critic)


def wide_update_case(name, agents, f, h, n=200_003, device="cuda"):
    """``(label, args)`` of update kernel ``name`` on ``n`` random rows
    through freshly initialised networks at ``agents`` x obs width ``f``,
    hidden ``h``.  Old values 0.05 or 0.4 from the critic's own values, and
    behaviour log-probs as far from the actor's own, either side: the
    values and the ratios lie inside and outside the clip band of eps 0.2
    but never on its edge, where float32 and float64 may take different
    sides of a clip or a min and a row's whole gradient jumps.  Returns
    apart from both."""
    import math

    from marlnav_tpu_torch.models import Actor, Critic
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.utils.seeding import make_generator

    gen = make_generator(20 + f + h, device)
    net_gen = torch.Generator().manual_seed(h)
    x = torch.randn((n, agents * f), device=device, generator=gen)

    def margins():
        return torch.tensor([-0.4, -0.05, 0.05, 0.4], device=device)[
            torch.randint(0, 4, (n,), device=device, generator=gen)]

    if name == "fused_critic_grad":
        critic = Critic(f, agents, h, generator=net_gen).to(device)
        # Hidden biases of +-2 against pre-activations of spread at most 1
        # (x ~ N(0, 1), orthogonal W1): no unit sits at the ReLU's kink,
        # where the kernel's and float64's roundings may take different
        # sides and a row's whole term of dW1 and db1 jumps.
        with torch.no_grad():
            critic.fc1.bias.copy_(2.0 * torch.sign(torch.randn(
                h, device=device, generator=gen)))
            v = critic(x)[:, 0]
        return f"In {agents * f}, H {h}", (
            critic.fc1.weight.detach(), critic.fc1.bias.detach(),
            critic.fc2.weight.detach(), critic.fc2.bias.detach(), x,
            v + margins(), torch.randn(n, device=device, generator=gen), 0.2)
    actor = Actor(f, h, generator=net_gen).to(device)
    label = f"F {f}" + (f", H {h}" if name != "fused_actor_grad" else "")
    act = torch.rand((n, 2), device=device, generator=gen) * 2 - 1
    with torch.no_grad():
        hid = actor.fc1(x)
        var = torch.nn.functional.softplus(actor.fc_var(hid))
        lp = -0.5 * (2.0 * math.log(2.0 * math.pi) + torch.log(var).sum(1)
                     + ((act - torch.tanh(actor.fc_mu(hid))) ** 2
                        / var).sum(1))
    rows = (x, act, lp + margins(),
            torch.randn(n, device=device, generator=gen), 0.2, 0.001)
    weights = (fc._affine_compose(actor) if name == "fused_actor_grad" else
               tuple(p_.detach() for p_ in actor.parameters()))
    return label, (*weights, *rows)


# The wide widths phase 6 holds the update kernels at, (agents, obs
# width, hidden): a narrow critic (2 agents, hidden 32: In 20), -no 8
# (critic In 66, F 22), -hs 128, 4 agents with 8 obstacles (In 96), the
# widest critic instance (In 103), -hs 256 and -no 14 -hs 256 (two passes
# of the tensor-core body), the widest un-collapsed one (F 39 / H 256);
# past the instances, the run-time-width route: critic In 120 (-no 17),
# 210, 36 at H 512 (-hs 512), 103 at H 257 and 1040; un-collapsed F 40
# (-no 17), 70 at H 128 and 12 at H 512.
WIDE_UPDATE_WIDTHS = {
    "fused_critic_grad": [
        (2, 10, 32), (3, 22, 50), (3, 12, 128), (4, 24, 128), (1, 103, 128),
        (3, 12, 256), (3, 34, 256), (1, 103, 256), (3, 40, 50), (1, 210, 64),
        (3, 12, 512), (1, 103, 257), (1, 1040, 64)],
    "fused_actor_grad_uncollapsed": [
        (1, 22, 50), (1, 22, 128), (1, 32, 128), (1, 39, 128), (1, 12, 256),
        (1, 34, 256), (1, 39, 256), (1, 40, 50), (1, 70, 128), (1, 12, 512)]}
# The bf16 instances phase 15 holds beside the default widths.
WIDE_BF16_WIDTHS = {"fused_critic_grad": [(3, 12, 256), (3, 34, 50)],
                    "fused_actor_grad_uncollapsed": [(1, 12, 256),
                                                     (1, 34, 50)]}


def criterion_cases(device="cuda"):
    """Yield ``(kernel name, label, args, bf16)`` for every case at which
    phases 6 and 15 of the card script hold the tensor-core kernels
    (``TENSOR_CORE_WORK``) to the criterion: phase 6's float32 cases (a
    real collect's full batch at (1024, 1000) and (16384, 200), the first
    and last ``-bs 250`` slices, the collecting networks, 100,003 ragged
    rows, the wide widths) and phase 15's bf16 ones (the full batch, slice
    0, ``WIDE_BF16_WIDTHS``)."""
    import dataclasses

    from marlnav_tpu_torch.algo.mappo import minibatch_slices

    for p, t in ((1024, 1000), (16384, 200)):
        b = collected_batch(p, t, device)
        nets = {"fused_critic_grad": b.critic,
                "fused_actor_grad_uncollapsed": b.actor}
        full = {name: update_args(name, nets[name], b.mb, b.cfg)
                for name in TENSOR_CORE_WORK}
        for name in TENSOR_CORE_WORK:
            yield name, f"P={p} T={t} full batch", full[name], False
        if (p, t) != (1024, 1000):
            continue
        sliced = dataclasses.replace(b.cfg, batch_size=250)
        slices = minibatch_slices(b.buf, sliced)
        for i in (0, len(slices) - 1):
            for name in TENSOR_CORE_WORK:
                args = update_args(name, nets[name], slices[i], sliced)
                label = f"-bs 250 slice {i} ({slices[i].obs.shape[0]} steps)"
                yield name, label, args, False
                if i == 0:
                    yield name, "-bs 250 slice 0", args, True
        for name, net in (("fused_critic_grad", b.ts.critic),
                          ("fused_actor_grad_uncollapsed", b.ts.actor)):
            yield (name, "collecting networks (rows tied)",
                   update_args(name, net, b.mb, b.cfg), False)
        for name in TENSOR_CORE_WORK:
            r = ROWS_ARG[name]
            yield (name, "ragged 100,003 rows", tuple(
                x[:100_003] if r <= i < r + (3 if name == "fused_critic_grad"
                                             else 4) else x
                for i, x in enumerate(full[name])), False)
            yield name, f"P={p} T={t} full batch", full[name], True
        del b, full
    for name, cases in WIDE_UPDATE_WIDTHS.items():
        for agents, f, h in cases:
            yield (name, *wide_update_case(name, agents, f, h, device=device),
                   False)
    for name, cases in WIDE_BF16_WIDTHS.items():
        for agents, f, h in cases:
            yield (name, *wide_update_case(name, agents, f, h, device=device),
                   True)


def criterion_errors(name, args, bf16):
    """``{output: (kernel error, plain error, tolerance)}`` of update
    kernel ``name`` on ``args`` (``output_errors``): in float32 against
    the float64 plain version; in bf16 mode (``bf16``) the kernel and the
    plain bf16 version against float64 products of the same rounded
    operands."""
    kernel, plain = update_functions()[name]
    n = args[ROWS_ARG[name]].shape[0]
    wide = tuple(x.double() if torch.is_tensor(x) else x for x in args)
    if bf16:
        outs = (kernel(*args, True), plain(*args, True),
                plain(*args, True, torch.float64))
    else:
        outs = kernel(*args), plain(*args), plain(*wide)
    return dict(zip(UPDATE_OUTPUTS[name], output_errors(*outs, n)))


def time_grads(out_dir, errors=False):
    """{case: median ms} of the tensor-core gradient kernels of the checkout
    whose package is imported: the float32 critic on a real collect's full
    batch at (1024, 1000) and (16384, 200) and on its ``-bs 250`` slice 0,
    the un-collapsed actor on that slice (its path) and at full batch,
    each bf16 instance at (1024, 1000) and slice 0; a default repeat
    (``--fused-collect --fused-updates``, full batch) captured as a CUDA
    graph, and the first stage of the H42 continuation (600 repeats from
    ``docs/curriculum_r5s42_state.pkl``, in seconds, one run); with
    ``errors``, ``criterion_errors`` at every ``criterion_cases``
    case: ``(times, errors)``."""
    import dataclasses

    from marlnav_tpu_torch.algo.mappo import minibatch_slices
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops.graphs import CountedGraph
    from marlnav_tpu_torch.scripts import curriculum as cur

    fns = update_functions()
    res = {}
    for p, t in ((1024, 1000), (16384, 200)):
        b = collected_batch(p, t)
        nets = {"fused_critic_grad": b.critic,
                "fused_actor_grad_uncollapsed": b.actor}
        cases = {"full batch": (b.mb, b.cfg)}
        if (p, t) == (1024, 1000):
            sliced = dataclasses.replace(b.cfg, batch_size=250)
            cases["-bs 250 slice 0"] = (minibatch_slices(b.buf, sliced)[0],
                                        sliced)
        for label, (mb, cfg) in cases.items():
            for name in TENSOR_CORE_WORK:
                kernel = fns[name][0]
                args = update_args(name, nets[name], mb, cfg)
                for bf16 in ((False, True) if (p, t) == (1024, 1000)
                             else (False,)):
                    res[f"{name}{' bf16' if bf16 else ''} P={p} T={t} "
                        f"{label}"] = cuda_ms(
                            lambda: kernel(*args, bf16), reps=7, warmup=2)
        del b
    rep = training_repeat(["--fused-collect"], out_dir)
    rep.run()  # warm
    graph = CountedGraph()
    with graph.capture():
        rep.run()
    res["default graphed repeat"] = cuda_ms(graph.replay, reps=5, warmup=1)
    del rep, graph
    t0 = time.perf_counter()
    hist = cur.main([
        "--mode", "radius-noise-adaptive", "--seed", "42",
        "--repeats-per-stage", "600", "--group-soft", "50000",
        "--episode-len-small", "400", "--mean-eval", "--coarse-threshold",
        "0.01", "--fine-threshold", "0.01", "--consolidate", "20",
        "--resume-state", os.path.join("docs", "curriculum_r5s42_state.pkl"),
        "--max-stages", "32", "--out", os.path.join(out_dir, "h42")])
    torch.cuda.synchronize()
    res["H42 stage 32 (s, with the resume and the mean-eval)"] = \
        time.perf_counter() - t0
    res["H42 stage 32 repeats (s)"] = hist[0]["seconds"]
    errs = {}
    if errors:
        for name, label, args, bf16 in criterion_cases():
            key = f"{name}{' bf16' if bf16 else ''} {label}"
            errs[key] = criterion_errors(name, args, bf16)
    return res, errs


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


def compare(other, out_dir, group="steps"):
    """Both checkouts' builds, their ptxas lines where they differ, and
    the times of ``group`` in each (other, this, this, other), on one card:
    ``time_checkout`` ("steps") or ``time_grads`` ("grads", whose first run
    of each checkout also takes the criterion's errors); prints the times
    and the ratio other / this of their means, and for "grads" each
    checkout's outputs outside the plain version's reach."""
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
    runs, errs = [], {}
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        flags = ["--group", group]
        if group == "grads" and label not in errs:
            flags.append("--errors")
        times, errors = result(start(root, "--time", out_dir, *flags))
        runs.append((label, times))
        errs.setdefault(label, errors)
        print(f"{label} ({root}): {json.dumps(times)}", flush=True)
    for label, by_case in errs.items():
        if not by_case:
            continue
        out = [f"{case} {o} {ek:.2e} / {ep:.2e} (tol {tol:.2e})"
               for case, per in by_case.items()
               for o, (ek, ep, tol) in per.items()
               if not within_reach(ek, ep, tol)]
        print(f"{label}: {len(out)} outputs outside the plain version's "
              f"reach (error / plain version's, against float64), of "
              f"{sum(len(v) for v in by_case.values())}")
        for line in out:
            print(f"  {line}")
        with open(os.path.join(out_dir, f"criterion_{label}.json"),
                  "w") as fh:
            json.dump(by_case, fh, indent=1)
    for key in runs[0][1]:
        o_ms = [r[key] for label, r in runs if label == "other"]
        t_ms = [r[key] for label, r in runs if label == "this"]
        print(f"{key}: other {o_ms[0]:.4f} / {o_ms[1]:.4f} ms, this "
              f"{t_ms[0]:.4f} / {t_ms[1]:.4f} ms: "
              f"{statistics.mean(o_ms) / statistics.mean(t_ms):.2f}x")
    print(f"card: {card}")


def _child(what, out_dir, group="steps", errors=False):
    """One step of ``compare`` in the checkout at the working directory:
    its build logs (``--build``) or its times and errors (``--time``), one
    JSON line."""
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
    elif group == "grads":
        print(json.dumps(time_grads(out_dir, errors)))
    else:
        print(json.dumps((time_checkout(out_dir), {})))


if __name__ == "__main__":
    import contextlib
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", nargs="?", help="the other checkout's root")
    parser.add_argument("--out", help="directory for the training runs' "
                        "artifacts (default: a temporary one)")
    parser.add_argument("--group", choices=("steps", "grads"),
                        default="steps", help="what to time: the step "
                        "kernels (time_checkout) or the tensor-core gradient "
                        "kernels, a graphed repeat and a curriculum stage, "
                        "with the criterion's errors (time_grads)")
    parser.add_argument("--build", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--time", metavar="OUT", help=argparse.SUPPRESS)
    parser.add_argument("--errors", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.build or args.time:
        _child("build" if args.build else "time", args.time, args.group,
               args.errors)
    elif not args.other:
        parser.error("give the other checkout's root")
    else:
        with contextlib.ExitStack() as stack:
            compare(args.other, args.out or stack.enter_context(
                tempfile.TemporaryDirectory()), args.group)
