"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It builds the port's CUDA kernels from the sources in the
checkout (one ``nvcc`` per source, started together) and prints each
kernel's registers and spills (asserting that the affine actor kernel,
one instance for every obs width, does not spill, and that no instance
of the tensor-core body spills more than it did when this was written),
holds each kernel
against its plain PyTorch version (the collect and rollout kernels equal
on every output field, at a ragged env count too), checks the collect
kernel's random numbers, trains MAPPO through the port's entry point at
the default configuration (1024 envs, buffer 1000, 50 + 50 epochs) for 2
repeats with ``--fused-collect --fused-updates`` (the main path: every
kernel's launch count is read around it), times each phase of a repeat
on the fused update route (full batch; -bs 250 with the affine and with
the un-collapsed actor) and on the autograd one, runs one repeat with
sliced minibatches and one more with ``MARLNAV_ACTOR_LAYOUT=packed`` (the
un-collapsed actor gradient's path), holds the gradient kernels against
float64 also at ragged row counts and at the wide widths the JAX package
trains (-no 8, -no 14, -hs 128, -hs 256, 4 agents with 8 obstacles, an
odd obs width, the widest of each kernel's template instances, and past
them the run-time-width route: -no 17, -hs 512 and more) with each output's error
printed, times one ``torch.sum`` over the affine actor's bytes beside that
kernel, counts the tensor-core (HMMA) instructions in the SASS of every
instance of the critic's and the un-collapsed actor's shared kernel body,
holds the rollout kernel against its plain version (at every timed
shape, the bench's included) and against the collect kernel, runs the
bench (``python -m marlnav_tpu_torch.bench --plain`` at 16384 envs x 500
steps, the rollout kernel's path), holds the collect and rollout kernels'
run-time instance (9, 17 and 32 obstacles) against their plain versions
bit for bit at each lane width and times every width, at the main shapes
and against the env count (the ground of ``rt_lanes``), times the
templated collect at 1 to 8 obstacles, trains 2 short repeats with
``--fused-updates`` at ``-no 8``, ``-hs 128``, ``-hs 256``, ``-no 14``,
``-no 17`` and ``-hs 512`` on both actor routes, runs the card tests (``python -m pytest
tests_cuda``), holds the returns kernel against its plain loops bit for
bit (float32 and float64, discounted and GAE), runs the main path through
the CLI as CUDA graphs (``--jit-repeats 2``, and with
``--pipeline-repeats``) and holds it bit for bit against the eager loop,
times the collect tail and a repeat eager and graphed with the device's
busy share of a graphed repeat, resumes the main path from a checkpoint
bit for bit, then drives ``--bf16-updates`` (phase 15): holds each bf16 kernel
variant against its plain version in bf16 mode (within a quarter of the
bf16 - float32 gap, output by output, with its error against float64
products of the same rounded operands printed), trains the main path
with it (graphed equal to eager bit for bit), at -bs 250, packed, -hs 256,
-no 14, -hs 32, -no 14 -hs 256 and -no 17, and times each bf16 kernel and
a graphed bf16 repeat beside their float32 counterparts; runs the
diagnostics on the card (phase 16: -rc against the goldens and the CPU,
the trained actor's trajectory and its env-steps/s, -re
--save-animation or its error without matplotlib); uses the profiling
hooks (``utils/profiling.py``: a graphed repeat metered by
``Throughput``, a ``trace`` of one replay, ``checked_step`` on an env
step); trains the main path with ``--num-data 1`` (phase 18: NCCL at one
rank, eager and graphed, bit for bit against the runs without it, the
collectives counted and their cost timed) and on two ranks of this card
over gloo (phase 19: against one rank, and the sharded bench rollout
against one-process rollouts of each rank's envs); trains with
``--num-model 2`` on gloo ranks of this card (phase 20: a 1 x 2 grid on
the fused and the autograd routes and at ``-hs 512``, a 2 x 2 grid,
each against one process, with each rank's launches asserted, the
collectives of a repeat counted and the eager repeat timed in turns with
one process); runs the curriculum programs on the card (phase 21: the
JAX package's seed-42 radius-30 state read without the JAX package, a
policy-mean rollout from its rows against its plain version, the
gradient kernels in that trained regime, the first stage of the H42
continuation through ``python -m marlnav_tpu_torch.scripts.curriculum``
with its launches counted and no ``nvcc`` run, one stage from scratch,
the renderer's statistics and the quick sweep); runs the hold against
the JAX package at a cut size (phase 22: ``python -m
marlnav_tpu_torch.scripts.hold`` on 2 of its 16 seeds, 2 of H42's 20
stages and the quick sweep, each check's fields finite and its launches
counted); and times every kernel.  Phases 6 and 15 hold each output the
tensor cores sum in the templated gradient instances within the plain
version's reach (``timing.within_reach``: 4x its error against float64,
or 1% of the output's tolerance) and print every output's.  Each path's launch
counts are set to 0 just before it and read just after.  Every phase prints as it goes;
any failure exits non-zero.  The last three lines are the kernels' JSON
object, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  It exits non-zero, printing no result, where CUDA is
unavailable.  The training artifacts and a JSON record of the run go to
``--out`` (default: a temporary directory, removed at exit).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from marlnav_tpu_torch.timing import (ROWS_ARG, TENSOR_CORE_OUTPUTS,
                                      TENSOR_CORE_WORK, UPDATE_OUTPUTS,
                                      collected_batch,
                                      cuda_ms, output_errors, ptxas_summary,
                                      step_case, training_repeat,
                                      update_args, update_functions,
                                      wide_update_case, within_reach,
                                      WIDE_UPDATE_WIDTHS)

# Float operations of one env-step of the collect kernel (A=3, O=3, F=12),
# counted from ops/csrc/fused_collect.cu, each mul/add/compare/select and
# each sqrt, divide or transcendental as one: 18 geom calls x 44 (incl.
# the 8-term acos polynomial and the feature scaling) = 792; 3 agents x
# 159 (the 4 x 12 affine actor, tanh x2, softplus x2, Box-Muller, action
# and log-prob) = 477; dynamics 3 x 48 = 144; rewards and done 332; reset
# blend 83; step counter 2.  Philox's integer work is not counted.  With O
# obstacles (F = 6 + 2 O): 3 (3 + O) geom calls; the actor 3 (8F + 63);
# rewards 242 + 30 O (each obstacle's distance and two flags, 10 an agent);
# the reset blend 47 + 12 O.
def collect_ops_per_env_step(o):
    f = 6 + 2 * o
    return (3 * (3 + o) * 44 + 3 * (8 * f + 63) + 144 + (242 + 30 * o)
            + (47 + 12 * o) + 2)


# The rollout kernel (ops/csrc/fused_rollout.cu) takes the collect's step
# without the log-probs (3 agents x 9: two logs, two squares, four adds and
# the scale) and without the done flag and counters (4): 1,799 sampled.
# With the policy mean it also skips, per agent, the operator's two
# variance rows (4F: 48), two softplus (12), Box-Muller (36) and the
# sample (6): 1,493.
def rollout_ops_per_env_step(o, deterministic):
    f = 6 + 2 * o
    return (collect_ops_per_env_step(o) - 3 * 9 - 4
            - (3 * (4 * f + 54) if deterministic else 0))


# Float operations of one actor row of ops/csrc/fused_update.cu, counted
# the same way: z = A x + c, 8F + 4; the PPO chain (ppo_row), 91; the sums
# g_z x^T and g_z, 8F + 4; the loss sum, 1.  At F = 12: 292.


def actor_ops_per_row(f):
    return 16 * f + 100


# One critic row: W1 x + b1 and ReLU, 2 In H + 2H; v, 2H + 1; the loss
# chain (critic_row), 27; g_pre = w2 g_v (h > 0), 3H; dW2, 2H; db1, H; dW1,
# 2 In H; the loss and db2 sums, 2.  At In = 36, H = 50: 7,730.
def critic_ops_per_row(n_in, h):
    return 4 * n_in * h + 10 * h + 30


# One row of the un-collapsed actor kernel: h = W1 x + b1, H (2F + 1); the
# heads, 4 (2H + 1); the PPO chain, 91; dWmu and dWvar, 8H; g_h, 7H; db1,
# H; dW1, 2HF; the loss and head-bias sums, 5.  At F = 12, H = 50: 3,750.
def uncollapsed_ops_per_row(f, h):
    return 4 * f * h + 25 * h + 100


HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 without tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
# Kernels whose products fit the tensor cores (TPU rows 3, 4, 6 and 7;
# TENSOR_CORE_WORK): their bound takes the TF32 rate, with the 67 TFLOP/s
# share beside it.
KERNELS = {
    "fused_collect": dict(
        source="marlnav_tpu_torch/ops/csrc/fused_collect.cu",
        replaces="marlnav_tpu/ops/fused_collect.py:327"),
    "fused_actor_grad": dict(
        source="marlnav_tpu_torch/ops/csrc/fused_update.cu",
        replaces="marlnav_tpu/ops/fused_update_tiled.py:226 and "
                 "marlnav_tpu/ops/fused_update.py:758"),
    "fused_critic_grad": dict(
        source="marlnav_tpu_torch/ops/csrc/fused_update.cu",
        replaces="marlnav_tpu/ops/fused_update_tiled.py:347 and "
                 "marlnav_tpu/ops/fused_update.py:844"),
    "fused_actor_grad_uncollapsed": dict(
        source="marlnav_tpu_torch/ops/csrc/fused_update.cu",
        replaces="marlnav_tpu/ops/fused_update.py:509 and "
                 "marlnav_tpu/ops/fused_update.py:618"),
    "fused_rollout": dict(
        source="marlnav_tpu_torch/ops/csrc/fused_rollout.cu",
        replaces="marlnav_tpu/ops/fused_rollout.py:312"),
    "returns": dict(
        source="marlnav_tpu_torch/ops/csrc/returns.cu",
        replaces="marlnav_tpu/algo/mappo.py:96 and marlnav_tpu/algo/"
                 "mappo.py:134 (XLA scans, no Pallas kernel)"),
}
# The shape each kernel's path runs it at, reported as its "ms": the
# default full batch, P=1024 x T=1000, unless given here.  The
# un-collapsed actor gradient's path is the -bs 250 repeat (P=1024 x 250
# steps a slice), the rollout's the bench.
MAIN_SHAPE = {"fused_actor_grad_uncollapsed": (1024, 250),
              "fused_rollout": (16384, 500)}
# The returns kernel's bound: its bytes, or the carry's chain of dependent
# operations a step times their latency, whichever is longer.  The chain
# (ops/csrc/returns.cu): discounted, a multiply, an add and a select; GAE,
# a multiply and an add (the rest of a step does not wait on the carry).
# Latency taken as 4 cycles a float32 operation and 8 a float64 one, at
# the H100 SXM's 1.98 GHz boost clock.
RETURNS_CHAIN_OPS = {False: 3, True: 2}  # by gae
RETURNS_OP_CYCLES = {torch.float32: 4, torch.float64: 8}
SM_CLOCK_HZ = 1.98e9
# Spill stores (bytes) of the tensor-core instances that spill, by (head,
# KS, NT), as the CUDA 12.9 toolkit's ptxas reports them for sm_90a: none
# since every instance takes one block an SM (the default un-collapsed
# actor spilled 12 B at 128 registers, CriticHead<16> at KS 9 4 B).
SPILL_STORES_TODAY = {}


_PHASE_START = [None]


def phase(title):
    """Start a phase; print how long the one before took."""
    now = time.perf_counter()
    if _PHASE_START[0] is not None:
        print(f"(phase took {now - _PHASE_START[0]:.1f} s)")
    _PHASE_START[0] = now
    print(f"\n=== {title} ===", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, reps=3):
    """Medians over ``reps`` runs of ``fn()``, in ms: the device time (CUDA
    events), the host's time to enqueue the work (until ``fn`` returns),
    and the host's wall time until the device is done."""
    dev_ms, enq_ms, wall_ms = [], [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dev_ms.append(start.elapsed_time(end))
        enq_ms.append((t1 - t0) * 1e3)
        wall_ms.append((t2 - t0) * 1e3)
    return {"device": statistics.median(dev_ms),
            "enqueue": statistics.median(enq_ms),
            "wall": statistics.median(wall_ms)}


def sass_hmma(sass, pattern, key, op="HMMA"):
    """{key(match): ``op`` instructions (tensor-core HMMA, or float64
    DMMA)} of each function of ``cuobjdump -sass`` output whose name
    matches ``pattern``."""
    counts, at = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            at = key(m) if m else None
            if at:
                counts[at] = 0
        elif at and op in line:
            counts[at] += 1
    return counts


def hmma_counts(sass, bf16=False, op="HMMA"):
    """{(head, KS, NT): ``op`` instructions} of each instance of
    tc_grad_kernel<CriticHead<NT> or ActorHead<NT>, KS> (with ``bf16``,
    CriticHeadBf16 or ActorHeadBf16)."""
    head = "HeadBf16" if bf16 else "Head"
    return sass_hmma(sass, r"tc_grad_kernelI\w*?(Critic|Actor)" + head +
                     r"ILi(\d+)EEELi(\d+)E",
                     lambda m: (m.group(1).lower(), int(m.group(3)),
                                int(m.group(2))), op)


def rt_hmma_counts(sass):
    """{(part, actor, bf16, one pass): HMMA instructions} of each instance
    of the run-time-width route's rt_forward_kernel<kActor, BF, kOnePass> /
    rt_backward_kernel<kActor, BF> (one pass 0)."""
    return sass_hmma(sass, r"rt_(forward|backward)_kernelILb(\d)ELb(\d)E"
                     r"(?:Lb(\d)E)?",
                     lambda m: (m.group(1), int(m.group(2)), int(m.group(3)),
                                int(m.group(4) or 0)))


def collect_errors(k, r):
    """Largest absolute difference of each float output of two collects."""
    errs = {f: (getattr(k, f) - getattr(r, f)).abs().max().item()
            for f in ("obs", "actions", "log_probs", "rewards")}
    errs["state"] = max((x - y).abs().max().item()
                        for x, y in zip(k.rows.fields(), r.rows.fields()))
    return errs


def instance_line(log, mangled):
    """ptxas -v's register and spill figures of the kernel instance whose
    mangled name contains ``mangled``."""
    found = [line.split(": ", 1)[1] for line in ptxas_summary(log)
             if mangled in line]
    return "; ".join(found) if found else f"{mangled}: no ptxas line"


def least_squares_slope(ms_by_o):
    """The least-squares slope of {O: ms}, in ms an obstacle."""
    xs, ys = list(ms_by_o), list(ms_by_o.values())
    mx, my = statistics.mean(xs), statistics.mean(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


SWEEP_ENVS = (1024, 2048, 4096, 8192, 16384)


def lane_sweep(label, widths, make, launch):
    """Medians of 3 of a step kernel's run-time instance at each lane width
    (``launch(sm, rows, a_comp, c_comp, lanes)``) at O 9, 17, 32 and P in
    SWEEP_ENVS (``make(p, o)``), each line with its fastest width and
    rt_lanes's pick marked; returns {"O=o P=p": {lanes: ms}}."""
    from marlnav_tpu_torch.ops import fused_collect as fc

    sweep = {}
    for o in (9, 17, 32):
        for p in SWEEP_ENVS:
            args = make(p, o)
            ms = {g: cuda_ms(lambda: launch(*args, g), reps=3, warmup=1)
                  for g in widths}
            best, pick = min(ms, key=ms.get), fc.rt_lanes(widths, p, o)
            print(f"  {label} O={o} P={p} T=200: " + ", ".join(
                f"{g} {v:.4f} ms" + (" best" if g == best else "")
                + (" pick" if g == pick else "") for g, v in ms.items()))
            sweep[f"O={o} P={p}"] = ms
    return sweep


def profile_run(label, fn):
    """Run ``fn()`` once under torch.profiler (its own overhead included)
    and print the device's busy time against the wall time, the largest
    kernels and host operations, and the host's kernel launch calls
    (``cudaLaunchKernel`` and its kin) and graph launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Device-side ranges of host annotations (Adam's "Optimizer.step")
    # overlap the kernels: count kernels and copies only.
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.key not in host_keys]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    if busy_ms > 0:
        print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms"
              f" = {busy_ms / wall_ms:.1%}; largest kernels:")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6}"
                  f" {e.key[:70]}")
    else:
        print(f"{label}: wall {wall_ms:.3f} ms; the profiler recorded no "
              "device time: busy share not measured")
    ours = {e.key.split("(")[0]: (e.count, e.self_device_time_total / 1e3)
            for e in on_device if "marlnav" in e.key}
    nccl = {e.key[:70]: (e.count, e.self_device_time_total / 1e3)
            for e in on_device if "nccl" in e.key.lower()}
    print("  the port's kernels (count, ms): " + "; ".join(
        f"{k[:60]} {c}, {t:.3f}" for k, (c, t) in sorted(ours.items())))
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    launches = {e.key: e.count for e in on_host if "LaunchKernel" in e.key
                or "GraphLaunch" in e.key}
    print(f"  host launch calls: {launches}")
    print("  largest host operations (self CPU time):")
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6}"
              f" {e.key[:70]}")
    host_nccl = {e.key: e.count for e in on_host
                 if e.key.startswith(("nccl:", "gloo:"))}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ops": sum(e.count for e in on_device),
            "launch_calls": launches, "ours": ours, "nccl": nccl,
            "host_collectives": host_nccl}


def trace_breakdown(label, fn, log_dir):
    """Run ``fn()`` once inside ``utils.profiling.trace`` (its trace file
    under ``log_dir``) and print the device time by kernel: each of the
    port's kernels, and the small kernels (PyTorch's own: elementwise,
    reductions, Adam, copies) by name, with the small kernels' share of
    the device time."""
    from torch.autograd import DeviceType

    from marlnav_tpu_torch.utils import trace

    torch.cuda.synchronize()
    with trace(log_dir) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.key not in host_keys]
    by_kernel = {e.key: (e.count, e.self_device_time_total / 1e3)
                 for e in on_device}
    total = sum(ms for _, ms in by_kernel.values())
    ours = sum(ms for k, (_, ms) in by_kernel.items() if "marlnav" in k)
    small = {k: v for k, v in by_kernel.items() if "marlnav" not in k}
    print(f"{label}: device time {total:.3f} ms over "
          f"{sum(c for c, _ in by_kernel.values())} kernels; the port's "
          f"kernels {ours:.3f} ms, the small kernels "
          f"{total - ours:.3f} ms ({(total - ours) / total:.1%}) over "
          f"{sum(c for c, _ in small.values())} launches"
          if total else f"{label}: the trace holds no device time")
    for k, (c, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"  {ms:9.3f} ms ({ms / total:6.1%})  x{c:<6} {k[:80]}")
    return {"device_ms": total, "ours_ms": ours, "small_ms": total - ours,
            "small_launches": sum(c for c, _ in small.values()),
            "by_kernel": by_kernel}


# Phase 19: the fused route at (P19, T19), 5 + 5 epochs, on uniforms drawn
# from a seeded generator on the card; the bench rollout at its headline.
P19, T19, ROLL19 = 2048, 100, (16384, 500)


def phase19_fused(mesh, dev):
    """collect -> actor -> critic on the fused route with injected noise,
    on ``mesh`` (None: one process); the results on the host."""
    return phase20_result(mesh, dev, "fused")


def phase19_rollout_inputs(dev):
    """The bench's rows at its headline and its actor (bench.py)."""
    from marlnav_tpu_torch import bench
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.utils.seeding import make_generator

    ep, icfg = bench._configs(ROLL19[0])
    rows = fc.env_state_to_rows(make_env(ep, icfg, dev).init(
        make_generator(0, dev)))
    return ep, icfg, rows, bench._actor(ep.obs_size, dev)


def phase19_rank(rank, world, out_dir):
    """A rank of phase 19: both ranks on cuda:0 over gloo."""
    from marlnav_tpu_torch.config import NormalizerConfig, ScalerConfig
    from marlnav_tpu_torch.ops.graphs import kernel_wrappers
    from marlnav_tpu_torch.ops.sharded import make_sharded_fused_rollout
    from marlnav_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cuda:0")
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = phase19_fused(mesh, mesh.device)
    out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    ep, icfg, rows, actor = phase19_rollout_inputs(mesh.device)
    roll = make_sharded_fused_rollout(ep, icfg, NormalizerConfig(),
                                      ScalerConfig(), ROLL19[1], mesh)
    final, rewards = roll(rows, actor, 9)
    out["rollout"] = (rewards.cpu(), [x.cpu() for x in final.fields()])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# Phase 20: --num-model at phase 19's shape over gloo on cuda:0, each
# grid's cases as (route, hidden size); the eager repeats timed in turns
# with one process (medians of P20_REPS).
P20_CASES = {"1x2": [("fused", 50), ("autograd", 50), ("autograd", 512)],
             "2x2": [("autograd", 50)]}
P20_REPS = 3


def phase20_setup(mesh, dev, route, hidden=50):
    """Phase 19's configuration at ``-hs hidden`` from seed 0, on ``mesh``
    (None: one process); returns ``(ts, state, repeat)``, ``repeat()``
    running collect -> actor -> critic once more on ``state[0]`` and
    returning its metrics and losses.  ``route`` "fused": the fused collect
    and updates on injected uniforms (phase 19's); "autograd": the plain
    collect with a tamed policy (mean head x1e-3, variance bias -20, as
    tests/test_fused_collect.py tames it: a reassociated head sum cannot
    steer an env into another collision) and autograd updates."""
    from marlnav_tpu_torch.__main__ import build_parser
    from marlnav_tpu_torch.algo import make_mappo
    from marlnav_tpu_torch.config import resolve_run_config
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops.step_math import StepMath
    from marlnav_tpu_torch.utils.seeding import make_generator

    fused = route == "fused"
    cfg = resolve_run_config(build_parser().parse_args(
        ["-np", str(P19), "-bl", str(T19), "-bs", str(T19), "-ne", "5",
         "-nt", str(P19 * T19), "-se", "0", "-hs", str(hidden)]
        + (["--fused-updates"] if fused else [])))
    env = make_env(cfg.env, cfg.init, dev, mesh=mesh)
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler, mesh=mesh)
    generator = make_generator(0, dev)
    ts, es = mappo.init(generator)
    if fused:
        collect = fc.make_fused_collect(cfg.model, cfg.env, cfg.init,
                                        cfg.normalizer, cfg.scaler, mesh)
        n_draws = StepMath(cfg.env, cfg.init, cfg.normalizer,
                           cfg.scaler).n_draws
        noise = torch.rand((T19, n_draws, P19), device=dev,
                           generator=torch.Generator(dev).manual_seed(19))
        state = [fc.env_state_to_rows(es)]
    else:
        with torch.no_grad():
            ts.actor.fc_mu.weight.mul_(1e-3)
            ts.actor.fc_mu.bias.mul_(1e-3)
            ts.actor.fc_var.bias.sub_(20.0)
        state = [es]

    def repeat():
        if fused:
            state[0], buf, met = collect(ts, state[0], 7, noise)
        else:
            state[0], buf, met = mappo.collect(ts, state[0], generator)
        _, al = mappo.train_actor(ts, buf)
        _, cl = mappo.train_critic(ts, buf)
        return met, al, cl

    return ts, state, repeat


def phase20_host(ts, state, route, met, al, cl):
    """A repeat's results on the host, the networks whole (gathered over
    the model group: every rank of it calls this)."""
    from marlnav_tpu_torch.parallel.tensor import gather_networks

    actor, critic = gather_networks([ts.actor, ts.critic])
    rows = state[0].fields() if route == "fused" else [state[0].states]
    return {"rows": [x.cpu() for x in rows], "al": al.cpu(),
            "cl": cl.cpu(), "mean_rew": float(met.mean_rew),
            "weights": [q.detach().cpu() for q in
                        (*actor.parameters(), *critic.parameters())]}


def phase20_result(mesh, dev, route, hidden=50):
    """One repeat of ``phase20_setup``'s, on the host."""
    ts, state, repeat = phase20_setup(mesh, dev, route, hidden)
    return phase20_host(ts, state, route, *repeat())


@contextlib.contextmanager
def counted_collectives(mesh):
    """Count ``torch.distributed``'s collectives while inside, by group
    ("model" for the mesh's model group, else "data") and kind."""
    import collections

    import torch.distributed as dist

    counts = collections.Counter()
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                           "broadcast")}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            group = kwargs.get("group")
            kind = ("model" if group is not None
                    and group is mesh.model_group else "data")
            counts[f"{kind} {name}"] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def phase20_rank(rank, world, out_dir, num_model):
    """A rank of phase 20: every rank on cuda:0 over gloo, a grid of
    world / num_model x num_model; each case's first repeat with its
    kernel launches and collectives counted, and at 1 x 2 the eager
    repeats timed in turns with one process (on rank 0, the other rank
    waiting)."""
    import torch.distributed as dist

    from marlnav_tpu_torch.ops.graphs import kernel_wrappers
    from marlnav_tpu_torch.parallel import make_mesh

    mesh = make_mesh(num_model=num_model, device="cuda:0")
    grid = f"{mesh.num_data}x{num_model}"
    wrappers = kernel_wrappers()
    out = {"grid": grid, "data": mesh.data_index, "model": mesh.model_index}
    for route, hidden in P20_CASES[grid]:
        ts, state, repeat = phase20_setup(mesh, mesh.device, route, hidden)
        for fn in wrappers.values():
            fn.launches = 0
        with counted_collectives(mesh) as counts:
            met, al, cl = repeat()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        out[(route, hidden)] = dict(
            phase20_host(ts, state, route, met, al, cl), launches=launches,
            collectives=dict(counts))
    if grid == "1x2":
        out["timed"] = {}
        for route in ("fused", "autograd"):
            mesh_repeat = phase20_setup(mesh, mesh.device, route)[2]
            one_repeat = (phase20_setup(None, mesh.device, route)[2]
                          if rank == 0 else None)
            runs = {"mesh": [], "one": []}
            for i in range(P20_REPS + 1):  # the first of each warms up
                if rank == 0:
                    runs["one"].append(timed(one_repeat, reps=1))
                dist.barrier()
                runs["mesh"].append(timed(mesh_repeat, reps=1))
            out["timed"][route] = {
                name: {k: statistics.median(r[k] for r in rs[1:])
                       for k in rs[0]} for name, rs in runs.items() if rs}
        # One collective's cost: 100 model-group all-reduces of the
        # actor's head partial at a collect step (P19 x 3 rows of 4) and
        # of one float, both ranks together.
        out["all_reduce_100"] = {}
        for label, shape in (("head partial", (P19 * 3, 4)),
                             ("scalar", ())):
            x = torch.zeros(shape, device=mesh.device)
            dist.barrier()
            out["all_reduce_100"][label] = timed(
                lambda: [dist.all_reduce(x, group=mesh.model_group)
                         for _ in range(100)], reps=3)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def main(out_dir):
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    import marlnav_tpu_torch

    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(marlnav_tpu_torch.__file__)) != here:
        sys.exit(f"chip_smoke: marlnav_tpu_torch imported from "
                 f"{marlnav_tpu_torch.__file__}, not from this checkout")
    from marlnav_tpu_torch import bench
    from marlnav_tpu_torch.__main__ import build_parser, cli
    from marlnav_tpu_torch.algo import make_mappo
    from marlnav_tpu_torch.algo.mappo import minibatch_slices
    from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                          NormalizerConfig, ScalerConfig,
                                          TriangleInitConfig,
                                          resolve_run_config)
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops import fused_rollout as fr
    from marlnav_tpu_torch.ops import fused_update as fu
    from marlnav_tpu_torch.ops import update_math as um
    from marlnav_tpu_torch.ops import returns as tr
    from marlnav_tpu_torch.ops._build import (BUILD_DIR, find_nvcc,
                                              load_libraries)
    from marlnav_tpu_torch.ops.graphs import CountedGraph, kernel_wrappers
    from marlnav_tpu_torch.train import train
    from marlnav_tpu_torch.utils import (Throughput, annotate, checked_step,
                                         trace)
    from marlnav_tpu_torch.utils.seeding import make_generator
    from torch.autograd import DeviceType

    dev = torch.device("cuda")
    norm, scal = NormalizerConfig(), ScalerConfig()
    record = {}
    # The main path runs the default actor layout and routing; the
    # un-collapsed path sets its layout itself.
    for knob in ("MARLNAV_ACTOR_LAYOUT", "MARLNAV_TILED_UPDATES"):
        os.environ.pop(knob, None)

    # ------------------------------------------------------------------
    phase("1. device and build")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    # Build from the sources on every run (an earlier build is removed):
    # the build log carries ptxas's register and spill report, which this
    # phase prints and checks.
    shutil.rmtree(BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    builds = load_libraries(["fused_collect", "fused_rollout", "fused_update",
                             "returns"])
    record["build_s"] = time.perf_counter() - t0
    print(f"all {len(builds)} libraries built in parallel: "
          f"{record['build_s']:.1f} s")
    record["ptxas"] = {}
    for name, (_, build) in builds.items():
        print(f"{name}: {build['seconds']:.1f} s -> {build['path']}")
        record["ptxas"][name] = ptxas_summary(build["log"])
        print("\n".join(record["ptxas"][name]))
    # The affine actor kernel: one instance for every obs width, whose
    # registers do not grow with F, for each rounding (float32, and the
    # bf16 roundings of the JAX package's tiled and staged routes); none
    # may spill.
    record["actor_ptxas"] = {}
    for mode, label in enumerate(("float32", "bf16 tiled", "bf16 staged")):
        actor_line = instance_line(builds["fused_update"][1]["log"],
                                   f"actor_grad_kernelILi{mode}E")
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                             actor_line)]
        print(f"actor_grad_kernel<{label}> (every obs width): {actor_line}")
        assert spills and not any(spills), actor_line
        record["actor_ptxas"][label] = actor_line
    # The run-time instances past the templated widths: the step kernels'
    # past 8 obstacles at each lane width they have (collect 8, 16, 32;
    # rollout 4, 8, 16, 32 in both modes), the gradient route past the
    # tensor-core instances (forward and backward, critic and un-collapsed
    # actor, float32 and bf16, and the critic's one pass in both).  None
    # may spill: the pin of every one of them is 0 bytes of spill stores.
    record["runtime_ptxas"] = {}
    for lib_name, mangled in (
            *(("fused_collect", f"fused_collect_rt_kernelILi{g}E")
              for g in fc.COLLECT_RT_LANES),
            *(("fused_rollout", f"fused_rollout_rt_kernelILi{g}ELb{mean}E")
              for g in fr.ROLLOUT_RT_LANES for mean in (0, 1)),
            *(("fused_update", f"rt_{part}_kernelILb{actor}ELb{bf16}E{one}")
              for part, one in (("forward", "Lb0E"), ("backward", "E"))
              for actor in (0, 1) for bf16 in (0, 1)),
            *(("fused_update", f"rt_forward_kernelILb0ELb{bf16}ELb1E")
              for bf16 in (0, 1))):
        line = instance_line(builds[lib_name][1]["log"], mangled)
        print(f"{mangled}: {line}")
        stores = re.findall(r"(\d+) bytes spill stores", line)
        assert stores and not any(int(v) for v in stores), line
        record["runtime_ptxas"][mangled] = line
    # The returns kernel's four instances (float32 / float64, discounted /
    # GAE) hold their carry and staging in registers and shared memory.
    returns_lines = record["ptxas"]["returns"]
    assert len(returns_lines) >= 4 and all(
        "0 bytes spill stores" in line for line in returns_lines
        if "spill" in line), returns_lines
    # The products of the critic and the un-collapsed actor on the tensor
    # cores: HMMA instructions in the SASS of every instance of their
    # shared body; its forward holds 3 KS NT a chunk.
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(os.path.realpath(find_nvcc())), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", builds["fused_update"][1]["path"]],
            capture_output=True, text=True, check=True).stdout
        hmma = hmma_counts(sass)
        # The forward of the instances of at most 8 n-tiles runs on the
        # float64 tensor cores: 4 DMMA (m8n8k4) a k-step and n-tile, in a
        # loop over the k-steps; the others' in 3xTF32.
        dmma = hmma_counts(sass, op="DMMA")
        spilled = {}
        for (head, ks, nt), count in sorted(hmma.items()):
            line = instance_line(builds["fused_update"][1]["log"],
                                 f"{head.capitalize()}HeadILi{nt}EEELi{ks}E")
            fwd = (f"{dmma[(head, ks, nt)]} DMMA: the forward" if nt <= 8
                   else f"forward: {3 * ks * nt} of them")
            print(f"tc_grad_kernel<{head.capitalize()}Head<NT={nt}>, KS={ks}>"
                  f": {count} HMMA in its SASS ({fwd}); " + line)
            assert (dmma[(head, ks, nt)] > 0) == (nt <= 8), (head, ks, nt)
            stores = re.findall(r"(\d+) bytes spill stores", line)
            assert stores, line
            spilled[(head, ks, nt)] = int(stores[0])
        assert {h for h, _, _ in hmma} == {"critic", "actor"}, hmma
        assert all(c > 0 for c in hmma.values()), hmma
        # No instance may spill more than it does today: none does.
        worse = {k: v for k, v in spilled.items()
                 if v > SPILL_STORES_TODAY.get(k, 0)}
        assert not worse, f"tc_grad_kernel spill stores grew: {worse}"
        record["tc_hmma"] = {f"{k}": c for k, c in hmma.items()}
        record["tc_dmma"] = {f"{k}": c for k, c in dmma.items()}
        # The bf16 instances (--bf16-updates): one m16n8k16 product a
        # k-step of 16, so a chunk's forward holds ceil(KS / 2) NT of them;
        # none may spill.
        hmma16 = hmma_counts(sass, bf16=True)
        for (head, ks, nt), count in sorted(hmma16.items()):
            line = instance_line(builds["fused_update"][1]["log"],
                                 f"{head.capitalize()}HeadBf16ILi{nt}EEELi"
                                 f"{ks}E")
            print(f"tc_grad_kernel<{head.capitalize()}HeadBf16<NT={nt}>, "
                  f"KS={ks}>: {count} HMMA in its SASS (forward: "
                  f"{(ks + 1) // 2 * nt}); " + line)
            stores = re.findall(r"(\d+) bytes spill stores", line)
            assert stores and int(stores[0]) == 0, line
        assert {h for h, _, _ in hmma16} == {"critic", "actor"}, hmma16
        assert all(c > 0 for c in hmma16.values()), hmma16
        record["tc_hmma_bf16"] = {f"{k}": c for k, c in hmma16.items()}
        # The run-time-width route's products on the tensor cores too: HMMA
        # in each of its ten kernels (their ptxas lines, no spill, above):
        # the forward and the backward of each network and precision, and
        # the critic's one pass in each precision.
        rt_hmma = rt_hmma_counts(sass)
        for (part, actor, bf16, one), count in sorted(rt_hmma.items()):
            print(f"rt_{part}_kernel<{'actor' if actor else 'critic'}, "
                  f"{'bf16' if bf16 else 'float32'}"
                  f"{', one pass' if one else ''}>: {count} HMMA in its SASS")
        assert len(rt_hmma) == 10 and all(c > 0 for c in rt_hmma.values()), \
            rt_hmma
        record["rt_hmma"] = {f"{k}": c for k, c in rt_hmma.items()}
    else:
        print("cuobjdump not found: HMMA count not measured")

    def setup(p, t, **case):
        """Step math, start rows and the actor operator of a step kernel
        over p envs (timing.step_case; t steps are the caller's)."""
        return step_case(p, device=dev, **case)

    # ------------------------------------------------------------------
    phase("2. kernel against its plain version, same uniforms")
    # Both perform the same float32 operations in the same order (the
    # kernel is built with -fmad=false), so every output field is asserted
    # equal: obs, actions, log-probs, rewards and the final rows to 0.0 max
    # abs error, done and the episode counters exactly.  Case d runs a
    # ragged env count (not a multiple of the envs a block takes) through
    # resets with noisy_ags.
    max_err = 0.0
    cases = [("a: P=2048 T=64, tamed policy", 2048, 64, dict(tame=True)),
             ("b: P=2048 1 step, untamed", 2048, 1, dict()),
             ("c: P=2048 episode_len=10, noisy_ags, resets", 2048, 40,
              dict(episode_len=10, noisy=True, tame=True)),
             ("d: P=1000 episode_len=10, noisy_ags, resets, untamed", 1000,
              40, dict(episode_len=10, noisy=True))]
    for name, p, t, kw in cases:
        sm, rows, a_comp, c_comp = setup(p, t, **kw)
        noise = torch.rand((t, sm.n_draws, p), device=dev,
                           generator=make_generator(5, dev))
        k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 7, t, noise)
        r = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
        torch.cuda.synchronize()
        errs = collect_errors(k, r)
        print(f"{name}: max abs err " + ", ".join(
            f"{f} {e:.3e}" for f, e in errs.items())
            + f"; done frac {k.done.float().mean().item():.4f}; counters "
            f"kernel {k.stats.tolist()} plain {r.stats.tolist()}")
        for f, e in errs.items():
            assert e == 0.0, f"{name}: {f} error {e}"
        assert torch.equal(k.done, r.done), f"{name}: done differs"
        assert torch.equal(k.stats, r.stats), f"{name}: counters differ"
        max_err = max(max_err, *errs.values())
        if name.startswith(("c", "d")):
            assert k.done.any(), f"{name} premise: resets fired"
    print("every field equal in every case")

    # ------------------------------------------------------------------
    phase("3. in-kernel Philox, P=16384, T=200")
    sm, rows, a_comp, c_comp = setup(16384, 200)
    o1 = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 11, 200)
    o2 = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 11, 200)
    o3 = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 12, 200)
    z_pre = o1.obs.reshape(-1, sm.obs_size) @ a_comp.T + c_comp
    mu = torch.tanh(z_pre[:, :2])
    var = torch.nn.functional.softplus(z_pre[:, 2:])
    z = ((o1.actions.reshape(-1, 2) - mu) / torch.sqrt(var)).double()
    z_mean, z_var = z.mean().item(), z.var().item()
    within1 = (z.abs() < 1.0).double().mean().item()
    print(f"z from actions: mean {z_mean:.5f}, var {z_var:.5f}, "
          f"P(|z|<1) {within1:.5f} over {z.numel()} draws")
    assert abs(z_mean) < 0.01 and abs(z_var - 1.0) < 0.01
    assert abs(within1 - 0.682689) < 0.005
    # The envs that finished at the last step (all that did not reset
    # earlier after a collision truncate there, episode_len 200) hold
    # fresh reset draws of their obstacles.
    fresh = o1.done[-1]
    print(f"envs finished at the last step: {fresh.float().mean().item():.4f}")
    assert fresh.float().mean().item() > 0.25
    icfg = sm.init_cfg
    for axis, lo, hi in (("x", icfg.obst_min_x, icfg.obst_max_x),
                         ("y", icfg.obst_min_y, icfg.obst_max_y)):
        v = (o1.rows.obx if axis == "x" else o1.rows.oby)[:, fresh].double()
        mean, var_u = v.mean().item(), v.var().item()
        print(f"reset obstacles {axis}: range [{v.min().item():.2f}, "
              f"{v.max().item():.2f}] in [{lo}, {hi}], mean {mean:.2f} "
              f"(uniform {(lo + hi) / 2}), var {var_u:.1f} (uniform "
              f"{(hi - lo) ** 2 / 12:.1f})")
        assert lo <= v.min().item() and v.max().item() <= hi
        assert abs(mean - (lo + hi) / 2) < 0.01 * (hi - lo)
        assert abs(var_u / ((hi - lo) ** 2 / 12) - 1.0) < 0.03
    same = all(torch.equal(getattr(o1, f), getattr(o2, f))
               for f in ("obs", "actions", "log_probs", "rewards"))
    differ = not torch.equal(o1.actions, o3.actions)
    print(f"same seed bitwise equal: {same}; other seed differs: {differ}")
    assert same and differ

    # ------------------------------------------------------------------
    phase("4. training (the main path): default configuration, 2 repeats, "
          "--fused-collect --fused-updates")
    p, t = 1024, 1000

    def run_config(extra, repeats=2):
        # defaults: -bl 1000 -bs 1000 -ne 50
        return resolve_run_config(build_parser().parse_args(
            ["-np", str(p), "-nt", str(repeats * p * t), "-se", "0",
             "--output-root", out_dir] + extra))

    counters = kernel_wrappers()
    assert set(counters) == set(KERNELS)
    path_launches = {}  # kernel -> launches on its path's run

    def expect(**counts):
        """Every kernel's count, 0 unless given."""
        return {name: counts.get(name, 0) for name in counters}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    cfg = run_config(["--fused-updates"])
    os.makedirs(out_dir, exist_ok=True)
    reset_counts()
    t0 = time.perf_counter()
    ts, rows_out, logger = train(cfg, device="cuda", fused_collect=True,
                                 output_root=out_dir)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    logs = logger.logs
    print(f"train: {train_s:.2f} s for 2 repeats; kernel launches "
          f"{launches}; mean_rew {logs['mean_rews']}; actor losses "
          f"{len(logs['actor'])}, critic losses {len(logs['critic'])}")
    assert launches == expect(fused_collect=2, fused_actor_grad=100,
                              fused_critic_grad=100, returns=2), launches
    for name in ("fused_collect", "fused_actor_grad", "fused_critic_grad",
                 "returns"):
        path_launches[name] = launches[name]
    assert len(logs["mean_rews"]) == 2 and len(logs["actor"]) == 100 \
        and len(logs["critic"]) == 100
    for key in ("mean_rews", "actor", "critic"):
        assert all(math.isfinite(v) for v in logs[key]), key
    assert all(x.shape[-1] == p and bool(torch.isfinite(x).all())
               for x in rows_out.fields())
    trained_actor = ts.actor  # phase 16 rolls a trajectory out with it

    # Per-phase times of one more repeat through the same functions, on the
    # fused and on the autograd update route, and at -bs 250 (4 minibatch
    # slices) with the affine and with the un-collapsed actor gradient:
    # the route MARLNAV_ACTOR_LAYOUT=packed takes the un-collapsed kernel
    # on, as the JAX package's staged route does.
    cfg_s = run_config(["--fused-updates", "-bs", "250"], repeats=1)
    routes = {"fused": (cfg.model, False),
              "autograd": (dataclasses.replace(cfg.model,
                                               fused_updates=False), False),
              "fused -bs 250": (cfg_s.model, False),
              "fused -bs 250, un-collapsed actor": (cfg_s.model, True)}
    env = make_env(cfg.env, cfg.init, dev)
    collect = fc.make_fused_collect(cfg.model, cfg.env, cfg.init,
                                    cfg.normalizer, cfg.scaler)
    record["phases_ms"] = {}
    for route, (model_cfg, uncollapsed) in routes.items():
        mappo = make_mappo(model_cfg, env, cfg.normalizer, cfg.scaler,
                           uncollapsed)
        ts, es = mappo.init(make_generator(0, dev))
        rows = fc.env_state_to_rows(es)
        out = {}

        def run_collect():
            out["c"] = collect(ts, rows, 100)
        ph = {"kernel": timed(lambda: collect.run_kernel(ts, rows, 100)),
              "collect": timed(run_collect)}
        buf = out["c"][1]
        ph["actor"] = timed(lambda: mappo.train_actor(ts, buf))
        ph["critic"] = timed(lambda: mappo.train_critic(ts, buf))
        ph["returns_tail"] = {k: ph["collect"][k] - ph["kernel"][k]
                              for k in ph["collect"]}
        ph["repeat"] = {k: ph["collect"][k] + ph["actor"][k]
                        + ph["critic"][k] for k in ph["collect"]}
        for name in ("kernel", "returns_tail", "actor", "critic", "repeat"):
            v = ph[name]
            print(f"{route} route, {name}: device {v['device']:.3f} ms, host "
                  f"enqueue {v['enqueue']:.3f} ms, host wall "
                  f"{v['wall']:.3f} ms (medians of 3)")
        rep = ph["repeat"]["device"]
        print(f"{route} route: repeat {rep:.3f} ms on the device = "
              f"{p * t / rep * 1e3:,.0f} env-steps/s")
        record["phases_ms"][route] = ph

    # Where a fused repeat's time goes, by torch.profiler (its own overhead
    # included): the device's busy share of the wall time, the largest
    # device kernels and host operations, and the kernel launch calls.
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler)
    ts, es = mappo.init(make_generator(0, dev))
    rows = fc.env_state_to_rows(es)

    def eager_repeat():
        buf = collect(ts, rows, 101)[1]
        mappo.train_actor(ts, buf)
        mappo.train_critic(ts, buf)

    record["profile"] = profile_run("profiled fused repeat", eager_repeat)

    # One repeat with sliced minibatches (-bs 250: 4 slices, the last one
    # short by the faithful last-step drop).
    reset_counts()
    t0 = time.perf_counter()
    _, _, logger_s = train(cfg_s, device="cuda", fused_collect=True,
                           output_root=out_dir, verbose=False)
    torch.cuda.synchronize()
    sliced = read_counts()
    print(f"-bs 250, 1 repeat: {time.perf_counter() - t0:.2f} s; kernel "
          f"launches {sliced}")
    assert sliced == expect(fused_collect=1, fused_actor_grad=200,
                            fused_critic_grad=200, returns=1), sliced
    assert len(logger_s.logs["actor"]) == 200
    for key in ("mean_rews", "actor", "critic"):
        assert all(math.isfinite(v) for v in logger_s.logs[key]), key

    # The un-collapsed actor gradient's path: the same -bs 250 repeat with
    # MARLNAV_ACTOR_LAYOUT=packed, where the JAX package runs its staged
    # "packed" actor kernel (TPU row 6; "undilated", row 7, routes alike).
    os.environ["MARLNAV_ACTOR_LAYOUT"] = "packed"
    try:
        reset_counts()
        t0 = time.perf_counter()
        _, _, logger_u = train(cfg_s, device="cuda", fused_collect=True,
                               output_root=out_dir, verbose=False)
        torch.cuda.synchronize()
        packed = read_counts()
    finally:
        del os.environ["MARLNAV_ACTOR_LAYOUT"]
    print(f"-bs 250, MARLNAV_ACTOR_LAYOUT=packed, 1 repeat: "
          f"{time.perf_counter() - t0:.2f} s; kernel launches {packed}; "
          f"mean_rew {logger_u.logs['mean_rews']}")
    assert packed == expect(fused_collect=1, fused_critic_grad=200,
                            fused_actor_grad_uncollapsed=200,
                            returns=1), packed
    path_launches["fused_actor_grad_uncollapsed"] = packed[
        "fused_actor_grad_uncollapsed"]
    assert len(logger_u.logs["actor"]) == 200
    for key in ("mean_rews", "actor", "critic"):
        assert all(math.isfinite(v) for v in logger_u.logs[key]), key

    # ------------------------------------------------------------------
    phase("5. collect kernel: times, and against its plain version at these "
          "shapes")
    def collect_bound(sm, rows, p, t):
        """(bound ms, what bounds it, bytes, operations) of a collect."""
        n_rows = sum(x.shape[0] for x in rows.fields())
        a, f = sm.a, sm.obs_size
        nbytes = (t * p * (4 * (a * f + 2 * a + a + 1) + 1)
                  + 2 * n_rows * p * 4 + 4 * (4 * f + 4) + 3 * 4)
        ops = collect_ops_per_env_step(sm.o) * t * p
        bytes_ms, ops_ms = (nbytes / HBM_BYTES_PER_S * 1e3,
                            ops / FP32_OPS_PER_S * 1e3)
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)

    shapes = {}
    for p, t in ((1024, 1000), (16384, 200), (16384, 500)):
        sm, rows, a_comp, c_comp = setup(p, t)
        k_ms = cuda_ms(lambda: fc.fused_collect_rows(sm, rows, a_comp, c_comp,
                                                     3, t), reps=7, warmup=2)
        uniforms = torch.rand((t, sm.n_draws, p), device=dev,
                              generator=make_generator(4, dev))
        plain_ms = cuda_ms(lambda: out.update(
            r=fc.collect_rows_reference(sm, rows, a_comp, c_comp, uniforms)))
        # The untamed initial actor over the whole rollout, resets included,
        # on the same uniforms: every field equal, as in phase 2.
        k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, t, uniforms)
        torch.cuda.synchronize()
        errs = collect_errors(k, out["r"])
        print(f"P={p} T={t} untamed, same uniforms: max abs err " + ", ".join(
            f"{f} {e:.3e}" for f, e in errs.items())
            + f"; done frac {k.done.float().mean().item():.4f}; counters "
            f"kernel {k.stats.tolist()} plain {out['r'].stats.tolist()}")
        for f, e in errs.items():
            assert e == 0.0, f"P={p} T={t}: {f} error {e}"
        assert torch.equal(k.done, out["r"].done)
        assert torch.equal(k.stats, out["r"].stats)
        max_err = max(max_err, *errs.values())
        bound_ms, bound_by, nbytes, ops = collect_bound(sm, rows, p, t)
        shapes[(p, t)] = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, us_per_step=k_ms * 1e3 / t)
        print(f"fused_collect P={p} T={t}: kernel {k_ms:.4f} ms (median of "
              f"7), {k_ms * 1e3 / t:.3f} us a step, plain version "
              f"{plain_ms:.1f} ms (1 run), bound "
              f"{bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB -> "
              f"{nbytes / HBM_BYTES_PER_S * 1e6:.1f} us; {ops / 1e9:.2f} "
              f"GFLOP -> {ops / FP32_OPS_PER_S * 1e6:.1f} us), "
              f"{bound_ms / k_ms:.1%} of the bound; "
              f"{p * t / k_ms * 1e3:,.0f} env-steps/s")
    print("fused_collect_kernel<O=3>: " + instance_line(
        builds["fused_collect"][1]["log"], "fused_collect_kernelILi3E"))

    # The templated instances at O 1 .. 8 at (1024, 1000): the compile-time
    # cost of an obstacle a step, the yardstick of the run-time instance's.
    tmpl_ms = {}
    for o in range(1, 9):
        sm, rows, a_comp, c_comp = setup(1024, 1000, o=o)
        tmpl_ms[o] = cuda_ms(lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 1000), reps=7, warmup=2)
    tmpl_slope = least_squares_slope(tmpl_ms)
    record["collect_templated_ms"] = tmpl_ms
    print("fused_collect_kernel<O> at P=1024 T=1000 (medians of 7): "
          + ", ".join(f"O {o} {v:.4f} ms" for o, v in tmpl_ms.items())
          + f"; least-squares slope {tmpl_slope * 1e3:.2f} ns a step an "
          f"obstacle")

    # Past 8 obstacles the run-time instance (fused_collect_rt_kernel<G>) at
    # each lane width G it has: at O 9, 17 and 32 every field equal to the
    # plain version through resets (episode_len 10, noisy_ags, ragged P
    # 1000, T 32: three truncation resets an env), and each width timed at
    # the main path's (1024, 1000), the chooser's pick (fc.rt_lanes) marked,
    # where every width's output also equals the pick's bit for bit.  Then
    # the crossover that rt_lanes's rule rests on: each width at P 1024 ..
    # 16384, T 200.
    widths = fc.COLLECT_RT_LANES
    rt_ms = {}
    for o in (9, 17, 32):
        sm, rows, a_comp, c_comp = setup(1000, 32, episode_len=10, noisy=True,
                                         o=o)
        uniforms = torch.rand((32, sm.n_draws, 1000), device=dev,
                              generator=make_generator(8, dev))
        plain_ms = cuda_ms(lambda: out.update(
            r=fc.collect_rows_reference(sm, rows, a_comp, c_comp, uniforms)))
        for g in widths:
            k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, 32,
                                      uniforms, lanes=g)
            torch.cuda.synchronize()
            errs = collect_errors(k, out["r"])
            assert all(e == 0.0 for e in errs.values()), (o, g, errs)
            assert torch.equal(k.done, out["r"].done) and k.done.any()
            assert torch.equal(k.stats, out["r"].stats)
        k_ms = cuda_ms(lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 32, uniforms), reps=7, warmup=2)
        print(f"O={o} P=1000 T=32 resets, same uniforms: every field equal "
              f"at lanes {widths}; done frac "
              f"{out['r'].done.float().mean().item():.4f}")
        bound_ms, by, _, _ = collect_bound(sm, rows, 1000, 32)
        shapes[f"O={o} 1000x32"] = dict(ms=k_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=by)
        sm, rows, a_comp, c_comp = setup(1024, 1000, o=o)
        pick = fc.rt_lanes(widths, 1024, o)
        by_g = {g: cuda_ms(lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 1000, lanes=g), reps=7, warmup=2)
            for g in widths}
        main_ms = by_g[pick]
        rt_ms[o] = main_ms
        outs = {g: fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, 1000,
                                         lanes=g) for g in widths}
        torch.cuda.synchronize()
        assert outs[pick].done.any()
        for g in widths:
            errs = collect_errors(outs[g], outs[pick])
            assert all(e == 0.0 for e in errs.values()), (o, g, errs)
            assert torch.equal(outs[g].done, outs[pick].done), (o, g)
            assert torch.equal(outs[g].stats, outs[pick].stats), (o, g)
        bound_ms, by, nbytes, ops = collect_bound(sm, rows, 1024, 1000)
        shapes[f"O={o} 1024x1000"] = dict(ms=main_ms, bound_ms=bound_ms,
                                          bound_by=by, lanes=pick,
                                          by_lanes=by_g)
        print(f"fused_collect O={o}: P=1000 T=32 kernel {k_ms:.4f} ms, "
              f"plain version {plain_ms:.1f} ms (1 run); P=1024 T=1000 "
              f"(every width == the pick) by lanes an env: " + ", ".join(
                  f"{g} {v:.4f} ms" + (" (the pick)" if g == pick else "")
                  for g, v in by_g.items())
              + f" (medians of 7); the pick {main_ms * 1e3 / 1000:.3f} us a "
              f"step, bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB; "
              f"{ops / 1e9:.2f} GFLOP), {bound_ms / main_ms:.1%} of it; "
              f"{1024 * 1000 / main_ms * 1e3:,.0f} env-steps/s")
    rt_slope = least_squares_slope(rt_ms)
    print(f"fused_collect run-time instance at its picks: slope "
          f"{rt_slope * 1e3:.2f} ns a step an obstacle over O 9, 17, 32 "
          f"(templated O 1 .. 8: {tmpl_slope * 1e3:.2f})")
    record["collect_rt_sweep"] = lane_sweep(
        "fused_collect", widths, lambda p, o: setup(p, 200, o=o),
        lambda sm, rows, a_comp, c_comp, g: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 200, lanes=g))
    times = {"fused_collect": shapes}
    errors = {"fused_collect": max_err}

    # ------------------------------------------------------------------
    phase("6. update kernels against their plain versions, and their times")
    # Inputs: the buffer of a real collect (the fused collect kernel, initial
    # networks) at each shape, faithful full batch (T - 1 steps), with
    # networks of another seed: their ratios spread around 1 (some rows
    # clipped) and their values leave the old ones' band.  With the
    # networks that collected, every ratio is ~1 and every value equals
    # its old one: all rows tie.  Errors:
    # each output sum divided by its row count (what Adam sees) against the
    # float64 plain version, with the float32 plain version's error beside
    # it.  Asserted: the kernel within 1e-4 of the output's largest
    # magnitude (+1e-7), and two launches equal bit for bit; the outputs
    # the tensor cores sum (timing.TENSOR_CORE_OUTPUTS) of the templated
    # instances also within the plain version's reach (timing.within_reach:
    # 4x its error, or 1% of that tolerance), every miss listed before the
    # phase fails.  The reach of every other output of the tensor-core
    # kernels (their head sums, the run-time route) is printed.
    fns = update_functions()
    rows_arg, outputs = ROWS_ARG, UPDATE_OUTPUTS
    actor_names = ("fused_actor_grad", "fused_actor_grad_uncollapsed")
    record["output_errors"] = {}
    misses = []

    def check(name, label, args, templated=True):
        kernel, plain = fns[name]
        n = args[rows_arg[name]].shape[0]
        k1, k2 = kernel(*args), kernel(*args)
        p32 = plain(*args)
        p64 = plain(*(x.double() if torch.is_tensor(x) else x for x in args))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k1, k2)), \
            f"{name} {label}: two launches differ"
        per_output = dict(zip(outputs[name], output_errors(k1, p32, p64, n)))
        err_k = max(e[0] for e in per_output.values())
        err_p = max(e[1] for e in per_output.values())
        print(f"{name} {label}: {n:,} rows; max abs err against float64: "
              f"kernel {err_k:.3e}, plain float32 {err_p:.3e}; two launches "
              f"bitwise equal")
        if name in TENSOR_CORE_WORK:
            # Which output carries the tensor-core kernels' error.
            print("  per output, kernel / plain float32: " + ", ".join(
                f"{o} {ek:.2e} / {ep:.2e} ({ek / ep if ep else math.inf:.1f}x"
                f"{'' if within_reach(ek, ep, tol) else ', MISSES'})"
                for o, (ek, ep, tol) in per_output.items()))
            record["output_errors"][f"{name} {label}"] = per_output
            held = TENSOR_CORE_OUTPUTS[(name, False)] if templated else ()
            misses.extend(f"{name} {label} {o}: {ek:.3e} against plain "
                          f"{ep:.3e}, tolerance {tol:.3e}"
                          for o, (ek, ep, tol) in per_output.items()
                          if o in held and not within_reach(ek, ep, tol))
        for o, (ek, ep, tol) in per_output.items():
            assert ek <= tol, (f"{name} {label} {o}: error {ek} > {tol} "
                               f"(plain float32 {ep})")
        errors[name] = max(errors.get(name, 0.0), err_k)

    def update_work(name, n, mcfg, widths=None):
        """The bytes and float operations of ``name`` on ``n`` rows, at the
        widths (F, H, In) of ``mcfg`` unless given."""
        f, h, n_in = widths or (mcfg.obs_size, mcfg.hidden_size,
                                mcfg.num_agents * mcfg.obs_size)
        n_par = h * n_in + 2 * h + 1
        return {
            "fused_actor_grad": (
                n * (4 * f + 16) + 4 * (4 * f + 4) + 4 * (4 * f + 5),
                n * actor_ops_per_row(f)),
            "fused_critic_grad": (
                n * (4 * n_in + 8) + 4 * (2 * n_par + 1),
                n * critic_ops_per_row(n_in, h)),
            # rows as the affine actor's; the weights in, the sums out.
            "fused_actor_grad_uncollapsed": (
                n * (4 * f + 16) + 4 * (2 * (h * f + 5 * h + 4) + 1),
                n * uncollapsed_ops_per_row(f, h))}[name]

    def time_kernels(key, label, inputs, mcfg, widths=None, mode=None):
        """Each kernel and its plain version on ``inputs`` (in bf16 mode
        ``mode`` where given), against the bound, kept in ``times`` under
        ``key``."""
        for name, args in inputs.items():
            kernel, plain = fns[name]
            if mode is not None:
                args = (*args, mode)
            n = args[rows_arg[name]].shape[0]
            nbytes, ops = update_work(name, n, mcfg, widths)
            k_ms = cuda_ms(lambda: kernel(*args), reps=7, warmup=2)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            fp32_ms = ops / FP32_OPS_PER_S * 1e3
            tc_rate = TF32_OPS_PER_S if mode is None else BF16_OPS_PER_S
            ops_ms = (ops / tc_rate * 1e3 if name in TENSOR_CORE_WORK
                      else fp32_ms)
            bound_ms = max(bytes_ms, ops_ms)
            times[name][key] = dict(
                ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            rate = ("float32" if name not in TENSOR_CORE_WORK
                    else "TF32" if mode is None else "bf16")
            print(f"{name} {label}: {n:,} rows, kernel {k_ms:.4f} ms "
                  f"(median of 7), plain version {plain_ms:.3f} ms (median "
                  f"of 3), bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f}"
                  f" MB -> {bytes_ms * 1e3:.1f} us; {ops / 1e9:.2f} GFLOP "
                  f"-> {ops_ms * 1e3:.1f} us in {rate}), {bound_ms / k_ms:.1%}"
                  f" of the bound")
            if name in TENSOR_CORE_WORK:
                times[name][key]["fp32_bound_ms"] = max(bytes_ms, fp32_ms)
                print(f"  beside it, the float32 CUDA-core bound "
                      f"{max(bytes_ms, fp32_ms) * 1e3:.1f} us (67 TFLOP/s): "
                      f"{max(bytes_ms, fp32_ms) / k_ms:.1%} of it")

    for name in fns:
        times[name] = {}
    for p, t in ((1024, 1000), (16384, 200)):
        batch = collected_batch(p, t, dev)
        mcfg, ts, buf, mb = batch.cfg, batch.ts, batch.buf, batch.mb

        def all_inputs(smb, scfg_):
            return {name: update_args(name, batch.critic if name ==
                                      "fused_critic_grad" else batch.actor,
                                      smb, scfg_) for name in fns}

        inputs = all_inputs(mb, mcfg)
        for name, args in inputs.items():
            check(name, f"P={p} T={t} full batch", args)
        slice_inputs = None
        if (p, t) == (1024, 1000):
            main_inputs = inputs  # phase 15 holds the bf16 kernels on them
            sliced_cfg = dataclasses.replace(mcfg, batch_size=250)
            for i, smb in enumerate(minibatch_slices(buf, sliced_cfg)):
                if i in (0, sliced_cfg.num_minibatches - 1):
                    label = f"-bs 250 slice {i} ({smb.obs.shape[0]} steps)"
                    s_inputs = all_inputs(smb, sliced_cfg)
                    for name, args in s_inputs.items():
                        check(name, label, args)
                    if i == 0:
                        slice_inputs = s_inputs
            for name in actor_names:
                check(name, "collecting actor (ratios ~1, tied)",
                      update_args(name, ts.actor, mb, mcfg))
            check("fused_critic_grad", "collecting critic (all rows tied)",
                  update_args("fused_critic_grad", ts.critic, mb, mcfg))
            # A row count that leaves the last 16-row chunk (and the affine
            # actor's last tile) ragged.
            check("fused_actor_grad", "ragged 100,003 rows", tuple(
                x[:100_003] if i in (2, 3, 4, 5) else x
                for i, x in enumerate(inputs["fused_actor_grad"])))
            check("fused_critic_grad", "ragged 100,003 rows", tuple(
                x[:100_003] if i in (4, 5, 6) else x
                for i, x in enumerate(inputs["fused_critic_grad"])))
            check("fused_actor_grad_uncollapsed", "ragged 100,003 rows",
                  tuple(x[:100_003] if i in (6, 7, 8, 9) else x for i, x in
                        enumerate(inputs["fused_actor_grad_uncollapsed"])))

        time_kernels((p, t), f"P={p} T={t}", inputs, mcfg)
        if (p, t) == (1024, 1000):
            # A yardstick for the affine actor kernel, which bytes bound:
            # what one torch.sum reaches reading as many bytes.
            nbytes = update_work("fused_actor_grad",
                          inputs["fused_actor_grad"][4].shape[0], mcfg)[0]
            flat = torch.ones(nbytes // 4, device=dev)
            sum_ms = cuda_ms(lambda: flat.sum(), reps=7, warmup=2)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            record["actor_read_yardstick"] = dict(
                bytes=nbytes, sum_ms=sum_ms, bound_ms=bytes_ms)
            print(f"torch.sum over the affine actor's {nbytes / 1e6:.1f} MB: "
                  f"{sum_ms:.4f} ms (median of 7), {bytes_ms / sum_ms:.1%} "
                  f"of its bytes bound, {nbytes / sum_ms / 1e9:.2f} TB/s; "
                  f"the kernel "
                  f"{times['fused_actor_grad'][(p, t)]['ms'] / sum_ms:.2f}x "
                  f"its time")
            del flat
        if slice_inputs is not None:
            # The -bs 250 slices' shape: the un-collapsed kernel's path.
            time_kernels((p, 250), f"P={p} -bs 250 slice 0", slice_inputs,
                         mcfg)
            main_slice_inputs, main_mcfg = slice_inputs, mcfg

    # Other widths, on 200,003 random rows through freshly initialised
    # networks: a narrow critic (2 agents, hidden 32: In 20), the widths of
    # -no 8 (obs 22: critic In 66), -no 14 (obs 34: In 102), -hs 128, -hs
    # 256 (two passes of the tensor-core body), 4 agents with 8 obstacles
    # (In 96), an odd obs width (13) and the widest of each tensor-core
    # body's instances (critic In 103 = 1 x 103; In 66, 102 and 103 load
    # their rows 4 bytes a copy) and of the affine actor's narrow tiles
    # (obs 255).  Past the instances, the run-time-width route: critic In
    # 120 (-no 17), 210, 36 at H 512 (-hs 512) and 103 at H 257;
    # un-collapsed F 40 (-no 17), 70 at H 128 and 12 at H 512; and the
    # affine actor at obs 256 and 300.  Old values 0.05 or 0.4 from the
    # critic's own values, and behaviour log-probs as far from the actor's
    # own, either side: the values and the ratios lie inside and outside
    # the clip band of eps 0.2 but never on its edge, where float32 and
    # float64 may take different sides of a clip or a min and a row's
    # whole gradient jumps.  Returns apart from both (timing.
    # wide_update_case).
    lib = fu._library()
    n = 200_003
    assert (1, lib.marlnav_critic_max_in(), lib.marlnav_max_hidden()) in \
        WIDE_UPDATE_WIDTHS["fused_critic_grad"]
    assert (1, lib.marlnav_uncollapsed_max_obs(), lib.marlnav_max_hidden()) \
        in WIDE_UPDATE_WIDTHS["fused_actor_grad_uncollapsed"]
    wide = {**WIDE_UPDATE_WIDTHS,
            "fused_actor_grad": [(1, 22, 50), (1, 32, 50), (1, 34, 50),
                                 (1, 13, 50), (1, 255, 50), (1, 256, 50),
                                 (1, 300, 50)]}

    def wide_case(name, agents, f, h):
        """(label, args) of ``name`` on n random rows at these widths."""
        return wide_update_case(name, agents, f, h, n, dev)

    # Phase 15's bf16 check (described there); the width --bf16-updates -hs
    # 64 trains is held to it below.
    bf16_modes = {"fused_actor_grad": ("tiled", "staged"),
                  "fused_critic_grad": (True,),
                  "fused_actor_grad_uncollapsed": (True,)}
    record["bf16"] = {"errors": {}}

    def check16(name, mode, label, args, templated=True):
        kernel, plain = fns[name]
        k1, k2 = kernel(*args, mode), kernel(*args, mode)
        p16, p32 = plain(*args, mode), plain(*args)
        p64 = plain(*args, mode, torch.float64)
        torch.cuda.synchronize()
        tag = f"{name} bf16{'' if mode is True else ' ' + mode} {label}"
        assert all(torch.equal(a, b) for a, b in zip(k1, k2)), \
            f"{tag}: two launches differ"
        per = {}
        for o, k, b, f32, w in zip(outputs[name], k1, p16, p32, p64):
            err = (k - b).abs().max().item()
            gap = (b - f32).abs().max().item()
            e64 = (k.double() - w).abs().max().item()
            scale = w.abs().max().item()
            per[o] = dict(err=err, gap=gap, err64=e64,
                          rel64=e64 / scale if scale else 0.0)
            if gap > 0.0:
                assert err <= 0.25 * gap, (f"{tag} {o}: |kernel - plain "
                                           f"bf16| {err} > 1/4 of {gap}")
            else:
                assert err <= 1e-4 * scale + 1e-7, f"{tag} {o}: {err}"
        print(f"{tag}: per output, |kernel - plain bf16| / bf16 - f32 gap; "
              f"against float64 of the rounded operands (share of max): "
              + ", ".join(f"{o} {v['err']:.2e} / {v['gap']:.2e}; "
                          f"{v['err64']:.2e} ({v['rel64']:.1e})"
                          for o, v in per.items()))
        if name in TENSOR_CORE_WORK:
            # The criterion against the plain bf16 version's own error
            # (both as means, against float64 of the rounded operands).
            n_rows = args[rows_arg[name]].shape[0]
            reach = dict(zip(outputs[name], output_errors(k1, p16, p64,
                                                          n_rows)))
            print("  per output against float64 as means, kernel / plain "
                  "bf16: " + ", ".join(
                      f"{o} {ek:.2e} / {ep:.2e}"
                      f"{'' if within_reach(ek, ep, tol) else ' (MISSES)'}"
                      for o, (ek, ep, tol) in reach.items()))
            held = TENSOR_CORE_OUTPUTS[(name, True)] if templated else ()
            for o, (ek, ep, tol) in reach.items():
                per[o]["reach"] = (ek, ep, tol)
                if o in held and not within_reach(ek, ep, tol):
                    misses.append(f"{tag} {o}: {ek:.3e} against plain bf16 "
                                  f"{ep:.3e}, tolerance {tol:.3e}")
        record["bf16"]["errors"][tag] = per

    def runtime_route(name, agents, f, h):
        """Whether these widths take the run-time-width route."""
        if name == "fused_critic_grad":
            return not lib.marlnav_critic_warps(agents * f, h, 0)
        if name == "fused_actor_grad_uncollapsed":
            return not lib.marlnav_uncollapsed_warps(f, h, 0)
        return False

    for name, cases in wide.items():
        for agents, f, h in cases:
            label, args = wide_case(name, agents, f, h)
            templated = not runtime_route(name, agents, f, h)
            if not templated:
                label += " (run-time route)"
            check(name, label, args, templated)
            time_kernels(label, label, {name: args}, None,
                         (f, h, agents * f))
    # What --bf16-updates -hs 64 trains: the critic at In 36 / H 64, which
    # has no bf16 instance, through the run-time route's bf16 kernels.
    assert not lib.marlnav_critic_warps(36, 64, 1)
    label, args = wide_case("fused_critic_grad", 3, 12, 64)
    label += " (run-time route)"
    check16("fused_critic_grad", True, label, args, False)  # tagged bf16
    time_kernels(f"bf16 {label}", f"bf16 {label}",
                 {"fused_critic_grad": args}, None, (12, 64, 36), mode=True)
    # A record, no routing change: the run-time route (fu._rt_grad_sums
    # called directly) beside the tensor-core instance at three templated
    # widths, on the same inputs, two launches each bitwise equal.
    record["rt_at_instances"] = {}
    for agents, f, h in ((3, 12, 50), (1, 103, 128), (3, 34, 256)):
        label, args = wide_case("fused_critic_grad", agents, f, h)
        w1, b1, w2, b2, x, vold, ret, eps = args
        n_in = agents * f
        assert lib.marlnav_critic_warps(n_in, h, 0)  # an instance
        n_out = 1 + h * n_in + 2 * h + 1

        def direct():
            return fu._rt_grad_sums(lib, False, x, (vold, ret, None), w1, b1,
                                    (w2, b2, None, None), n_in, h, eps,
                                    (0.0,) * 4, False, n_out,
                                    bool(lib.marlnav_rt_one_pass(0, n_in, h)))
        r1, r2 = direct(), direct()
        want = um.critic_grad_sums_reference(
            *(v.double() if torch.is_tensor(v) else v for v in args))
        torch.cuda.synchronize()
        assert torch.equal(r1, r2), label
        shapes = ((), (h, n_in), (h,), (1, h), (1,))
        for o, k, w in zip(outputs["fused_critic_grad"],
                           fu._split(r1, shapes), want):
            err = (k.double() - w).abs().max().item() / n  # as a mean
            assert err <= 1e-4 * w.abs().max().item() / n + 1e-7, (label, o)
        inst_ms = cuda_ms(lambda: fu.critic_grad_sums(*args), reps=7,
                          warmup=2)
        rt_ms = cuda_ms(direct, reps=7, warmup=2)
        record["rt_at_instances"][label] = dict(instance_ms=inst_ms,
                                                rt_ms=rt_ms)
        print(f"fused_critic_grad {label}, {n:,} rows: tensor-core instance "
              f"{inst_ms:.4f} ms, run-time route called directly "
              f"{rt_ms:.4f} ms ({rt_ms / inst_ms:.2f}x; medians of 7)")
    print(f"outputs outside the plain version's reach: {len(misses)}"
          + "".join(f"\n  {m}" for m in misses))
    assert not misses, "phase 6: outputs outside the plain version's reach"

    # ------------------------------------------------------------------
    phase("7. rollout kernel against its plain version and the collect "
          "kernel; its times")
    # Both routes perform the same float32 operations in the same order,
    # and the sampled rollout draws the collect's Philox slots: every
    # comparison is asserted equal, rewards and final rows.  episode_len 50
    # with noisy_ags: every env resets at least 4 times, so the reset draws
    # (slot 2A and up, in both modes) are read.  P=1000 is ragged.
    def same_rollout(a, b):
        """Largest difference of the rewards and the final rows."""
        return max((x - y).abs().max().item() for x, y in
                   zip((a[1], *a[0].fields()), (b[1], *b[0].fields())))

    t = 200
    errors["fused_rollout"] = 0.0
    for p in (2048, 1000):
        sm, rows, a_comp, c_comp = setup(p, t, episode_len=50, noisy=True)
        uniforms = torch.rand((t, sm.n_draws, p), device=dev,
                              generator=make_generator(6, dev))
        for det in (False, True):
            k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, t, det,
                                      uniforms)
            r = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, uniforms,
                                          det)
            torch.cuda.synchronize()
            err = same_rollout(k, r)
            resets = int((k[0].misc[0] == 0).sum())
            print(f"P={p} rollout {'policy-mean' if det else 'sampled'}: "
                  f"kernel == plain: max abs err {err:.3e}; mean reward "
                  f"{k[1].mean().item():.2f}; envs just reset {resets}")
            assert err == 0.0, f"rollout P={p} det={det}: kernel != plain " \
                f"({err})"
            assert math.isfinite(k[1].mean().item())
            errors["fused_rollout"] = max(errors["fused_rollout"], err)
        col = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 11, t)
        k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, t, False)
        torch.cuda.synchronize()
        err = same_rollout(k, (col.rows, col.rewards))
        print(f"P={p} sampled rollout == collect kernel, Philox seed 11: max "
              f"abs err {err:.3e}; done frac "
              f"{col.done.float().mean().item():.4f}")
        assert err == 0.0, f"P={p}: rollout != collect ({err})"
        assert col.done.any()

    # At each timed shape, (16384, 500) the bench's own among them, the
    # sampled kernel is also held against the plain version's timed run on
    # the same uniforms: the untamed initial actor, resets included, bit
    # for bit.
    def rollout_bound(sm, rows, p, t):
        """(bound ms, what bounds it, bytes, operations) of a sampled
        rollout."""
        n_rows = sum(x.shape[0] for x in rows.fields())
        nbytes = t * p * 4 + 2 * n_rows * p * 4 + 4 * (4 * sm.obs_size + 4)
        ops = rollout_ops_per_env_step(sm.o, False) * t * p
        bytes_ms, ops_ms = (nbytes / HBM_BYTES_PER_S * 1e3,
                            ops / FP32_OPS_PER_S * 1e3)
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)

    times["fused_rollout"] = {}
    for p, t in ((1024, 1000), (16384, 200), (16384, 500)):
        sm, rows, a_comp, c_comp = setup(p, t)
        k_ms = cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 3, t, False), reps=7, warmup=2)
        det_ms = cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 3, t, True), reps=7, warmup=2)
        uniforms = torch.rand((t, sm.n_draws, p), device=dev,
                              generator=make_generator(4, dev))
        plain = {}
        plain_ms = cuda_ms(lambda: plain.update(r=fr.rollout_rows_reference(
            sm, rows, a_comp, c_comp, uniforms, False)))
        k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 3, t, False,
                                  uniforms)
        torch.cuda.synchronize()
        err = same_rollout(k, plain["r"])
        resets = int((k[0].misc[0] == 0).sum())
        print(f"P={p} T={t} sampled, same uniforms: kernel == plain: max abs "
              f"err {err:.3e}; mean reward {k[1].mean().item():.2f}; envs "
              f"just reset {resets}")
        assert err == 0.0, f"rollout P={p} T={t}: kernel != plain ({err})"
        assert math.isfinite(k[1].mean().item())
        bound_ms, bound_by, nbytes, ops = rollout_bound(sm, rows, p, t)
        bytes_ms, ops_ms = (nbytes / HBM_BYTES_PER_S * 1e3,
                            ops / FP32_OPS_PER_S * 1e3)
        times["fused_rollout"][(p, t)] = dict(
            ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            policy_mean_ms=det_ms, us_per_step=k_ms * 1e3 / t)
        print(f"fused_rollout P={p} T={t}: kernel {k_ms:.4f} ms sampled "
              f"({k_ms * 1e3 / t:.3f} us a step), {det_ms:.4f} ms policy "
              f"mean ({det_ms * 1e3 / t:.3f} us a step; medians of 7), plain "
              f"version "
              f"{plain_ms:.1f} ms (1 run), bound {bound_ms * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB -> {bytes_ms * 1e3:.1f} us; "
              f"{ops / 1e9:.2f} GFLOP -> {ops_ms * 1e3:.1f} us), "
              f"{bound_ms / k_ms:.1%} of the bound; "
              f"{p * t / k_ms * 1e3:,.0f} env-steps/s")
    for det in (False, True):
        print(f"fused_rollout_kernel<O=3, {'policy mean' if det else 'sampled'}"
              f">: " + instance_line(builds["fused_rollout"][1]["log"],
                                     f"fused_rollout_kernelILi3ELb{int(det)}E"))
    # Past 8 obstacles the run-time instance (fused_rollout_rt_kernel<G,
    # kMean>) at each lane width G it has: at O 9, 17 and 32, both modes
    # equal to the plain version through resets at a ragged P 1000 (T 32,
    # episode_len 10), the sampled one equal to the collect kernel at each of
    # its widths from the same Philox seed; each width timed at the bench's
    # (16384, 500), both modes, the chooser's pick marked, where every
    # width's output also equals the pick's bit for bit.  Then the
    # crossover: each width at P 1024 .. 16384, T 200, both modes.
    widths = fr.ROLLOUT_RT_LANES
    for o in (9, 17, 32):
        sm, rows, a_comp, c_comp = setup(1000, 32, episode_len=10, noisy=True,
                                         o=o)
        uniforms = torch.rand((32, sm.n_draws, 1000), device=dev,
                              generator=make_generator(9, dev))
        small = {}
        for det in (False, True):
            plain = {}
            plain_ms = cuda_ms(lambda: plain.update(
                r=fr.rollout_rows_reference(sm, rows, a_comp, c_comp,
                                            uniforms, det)))
            for g in widths:
                k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, 32,
                                          det, uniforms, lanes=g)
                torch.cuda.synchronize()
                err = same_rollout(k, plain["r"])
                assert err == 0.0, f"rollout O={o} det={det} lanes {g}: " \
                    "kernel != plain"
            small[det] = plain_ms
        k_ms = cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 11, 32, False, uniforms), reps=7,
            warmup=2)
        cols = [fc.fused_collect_rows(sm, rows, a_comp, c_comp, 11, 32,
                                      lanes=g) for g in fc.COLLECT_RT_LANES]
        for g in widths:
            k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, 32, False,
                                      lanes=g)
            torch.cuda.synchronize()
            for col in cols:
                assert same_rollout(k, (col.rows, col.rewards)) == 0.0, (o, g)
        assert all(col.done.any() for col in cols)
        bound_ms, bound_by, _, _ = rollout_bound(sm, rows, 1000, 32)
        times["fused_rollout"][f"O={o} 1000x32"] = dict(
            ms=k_ms, plain_ms=small[False], bound_ms=bound_ms,
            bound_by=bound_by)
        sm, rows, a_comp, c_comp = setup(16384, 500, o=o)
        pick = fc.rt_lanes(widths, 16384, o)
        ms = {det: {g: cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 3, 500, det, lanes=g), reps=7, warmup=2)
            for g in widths} for det in (False, True)}
        for det in (False, True):
            outs = {g: fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 3, 500,
                                             det, lanes=g) for g in widths}
            torch.cuda.synchronize()
            for g in widths:
                assert same_rollout(outs[g], outs[pick]) == 0.0, (o, det, g)
        bound_ms, bound_by, _, _ = rollout_bound(sm, rows, 16384, 500)
        times["fused_rollout"][f"O={o} 16384x500"] = dict(
            ms=ms[False][pick], bound_ms=bound_ms, bound_by=bound_by,
            policy_mean_ms=ms[True][pick], lanes=pick, by_lanes=ms)
        print(f"fused_rollout O={o}: kernel == plain (both modes) at lanes "
              f"{widths} and == collect at lanes {fc.COLLECT_RT_LANES} at "
              f"P=1000 T=32 (kernel {k_ms:.4f} ms, plain "
              f"{small[False]:.1f} / {small[True]:.1f} ms); P=16384 T=500 "
              f"(every width == the pick) by lanes an env, sampled / policy "
              f"mean: " + ", ".join(
                  f"{g} {ms[False][g]:.4f} / {ms[True][g]:.4f} ms"
                  + (" (the pick)" if g == pick else "") for g in widths)
              + f" (medians of 7); bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}), {bound_ms / ms[False][pick]:.1%} of the pick's "
              f"sampled time; {16384 * 500 / ms[False][pick] * 1e3:,.0f} "
              f"env-steps/s")
    record["rollout_rt_sweep"] = {
        mode: lane_sweep(
            f"fused_rollout {mode}", widths, lambda p, o: setup(p, 200, o=o),
            lambda sm, rows, a_comp, c_comp, g: fr.fused_rollout_rows(
                sm, rows, a_comp, c_comp, 3, 200, det, lanes=g))
        for mode, det in (("sampled", False), ("policy mean", True))}

    # ------------------------------------------------------------------
    phase("8. the bench path: python -m marlnav_tpu_torch.bench --plain, "
          f"{bench.HEADLINE[0]} envs x {bench.HEADLINE[1]} steps")
    reset_counts()
    bench_out = io.StringIO()
    with contextlib.redirect_stdout(bench_out):
        result = bench.main(["--plain"])
    torch.cuda.synchronize()
    bench_launches = read_counts()
    line = json.loads(bench_out.getvalue().strip().splitlines()[-1])
    rates = result["routes"]
    print(f"bench line: {json.dumps(line)}")
    print(f"bench: fused rollout {rates['fused']:,.0f} env-steps/s, plain "
          f"loop {rates['plain']:,.0f} env-steps/s "
          f"({rates['fused'] / rates['plain']:.1f}x); mean rewards "
          f"{result['mean_rewards']}; kernel launches {bench_launches}")
    assert bench_launches == expect(fused_rollout=1 + bench.TIMED_CALLS), \
        bench_launches
    path_launches["fused_rollout"] = bench_launches["fused_rollout"]
    assert line["metric"] == "env_steps_per_s" and line["value"] > 0
    assert all(math.isfinite(v) for v in result["mean_rewards"].values())
    record["bench"] = result

    # ------------------------------------------------------------------
    phase("9. training at wide widths: -no 8, -hs 128, -hs 256, -no 14, "
          "-no 17 and -hs 512, 2 repeats, --fused-updates, both actor routes")
    # Widths the JAX package trains.  P=256 x buffer 100, 5 + 5 epochs: the
    # affine actor at full batch and the un-collapsed one
    # (MARLNAV_ACTOR_LAYOUT=packed) at -bs 50 (2 slices); with
    # --fused-collect, except at -no 14, which collects through the plain
    # step loop on the card (its update kernels see obs 34 and critic input
    # 102).  -no 17 runs the collect kernel's run-time instance and, for
    # the critic (In 120) and the un-collapsed actor (F 40), the run-time-
    # width route; -hs 512 the latter for both.  At -no 17 and -hs 512 only
    # the un-collapsed actor: phase 17 trains the affine one at full size.
    record["wide_training"] = {}
    epochs, wp, wt = 5, 256, 100
    for extra, fused_collect in (
            (["-no", "8"], True), (["-hs", "128"], True),
            (["-hs", "256"], True), (["-no", "14"], False),
            (["-no", "17"], True), (["-hs", "512"], True)):
        for layout, bs in ((None, wt), ("packed", wt // 2)):
            if layout is None and extra in (["-no", "17"], ["-hs", "512"]):
                continue  # the affine actor: trained at full size, phase 17
            wcfg = resolve_run_config(build_parser().parse_args(
                ["-np", str(wp), "-bl", str(wt), "-bs", str(bs), "-ne",
                 str(epochs), "-nt", str(2 * wp * wt), "-se", "0",
                 "--output-root", out_dir, "--fused-updates"] + extra))
            if layout:
                os.environ["MARLNAV_ACTOR_LAYOUT"] = layout
            try:
                reset_counts()
                _, _, wlog = train(wcfg, device="cuda",
                                   fused_collect=fused_collect,
                                   output_root=out_dir, verbose=False)
                torch.cuda.synchronize()
                wide_launches = read_counts()
            finally:
                os.environ.pop("MARLNAV_ACTOR_LAYOUT", None)
            grads = 2 * epochs * (wt // bs)
            actor_kernel = ("fused_actor_grad_uncollapsed" if layout
                            else "fused_actor_grad")
            label = (f"{' '.join(extra)}, "
                     f"{'un-collapsed' if layout else 'affine'} actor, "
                     f"-bs {bs}"
                     + ("" if fused_collect else ", plain collect"))
            logs = wlog.logs
            print(f"{label}: obs {wcfg.model.obs_size}, critic input "
                  f"{wcfg.model.num_agents * wcfg.model.obs_size}, hidden "
                  f"{wcfg.model.hidden_size}; kernel launches "
                  f"{wide_launches}; mean_rew {logs['mean_rews']}; last "
                  f"losses actor {logs['actor'][-1]:.6f}, critic "
                  f"{logs['critic'][-1]:.6f}")
            assert wide_launches == expect(
                fused_collect=2 if fused_collect else 0, returns=2,
                fused_critic_grad=grads, **{actor_kernel: grads}), (
                    label, wide_launches)
            assert len(logs["mean_rews"]) == 2
            for key in ("mean_rews", "actor", "critic"):
                assert all(math.isfinite(v) for v in logs[key]), (label, key)
            record["wide_training"][label] = {
                "launches": wide_launches, "mean_rews": logs["mean_rews"]}

    # ------------------------------------------------------------------
    phase("10. the card tests: python -m pytest tests_cuda -q")
    # The kernels against their plain versions under pytest, in a process
    # of their own (the libraries built above are found by their hash).
    t0 = time.perf_counter()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "tests_cuda", "-q",
         "-p", "no:cacheprovider"], cwd=here, capture_output=True, text=True)
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    counts = {word: int(num) for num, word in
              re.findall(r"(\d+) (passed|failed|errors?|skipped)", summary)}
    print(f"tests_cuda: {summary} (rc {tests.returncode}, "
          f"{time.perf_counter() - t0:.1f} s)")
    if tests.returncode != 0 or set(counts) != {"passed"}:
        print(tests.stdout[-6000:], tests.stderr[-2000:])
    assert tests.returncode == 0 and counts.get("passed", 0) > 0 \
        and set(counts) == {"passed"}, summary
    record["tests_cuda"] = counts

    # ------------------------------------------------------------------
    phase("11. the returns kernel against its plain loops, and its times")
    # Both perform the same float operations in the same order (-fmad=false),
    # so every value is asserted equal, float32 and float64, discounted and
    # GAE, at the default shape, at (16384, 200) and at a ragged P = 7, with
    # done on the first and the last step.  Each wrapper call counts one
    # launch.
    times["returns"], errors["returns"] = {}, 0.0
    for p, t in ((1024, 1000), (16384, 200), (7, 1000)):
        gen = make_generator(30 + p, dev)
        rew = 100.0 * torch.randn((t, p), device=dev, generator=gen)
        done = torch.rand((t, p), device=dev, generator=gen) < 0.02
        done[0], done[-1] = True, True
        values = torch.randn((t, p), device=dev, generator=gen)
        last = torch.randn(p, device=dev, generator=gen)
        for gae in (False, True):
            for dtype in (torch.float32, torch.float64):
                if gae:
                    args = (rew, done, 0.9, values, last, 0.95, dtype)
                    plain, plain_args = tr.gae_advantages_reference, (
                        rew, done, values, last, 0.9, 0.95, dtype)
                else:
                    args = (rew, done, 0.9, None, None, 1.0, dtype)
                    plain, plain_args = tr.discounted_returns_reference, (
                        rew, done, 0.9, dtype)
                before = tr.returns_scan.launches
                k1, k2 = tr.returns_scan(*args), tr.returns_scan(*args)
                want = plain(*plain_args)
                torch.cuda.synchronize()
                n_launches = tr.returns_scan.launches - before
                err = (k1 - want).abs().max().item()
                mode = f"{'gae' if gae else 'discounted'} " \
                       f"{'f64' if dtype == torch.float64 else 'f32'}"
                assert n_launches == 2, (mode, n_launches)
                assert torch.equal(k1, want), f"P={p} T={t} {mode}: {err}"
                assert torch.equal(k1, k2), f"P={p} T={t} {mode}: launches"
                errors["returns"] = max(errors["returns"], err)
                k_ms = cuda_ms(lambda: tr.returns_scan(*args), reps=7,
                               warmup=2)
                plain_ms = cuda_ms(lambda: plain(*plain_args))
                out_bytes = 8 if dtype == torch.float64 else 4
                nbytes = t * p * (4 + 1 + out_bytes + (4 if gae else 0)) \
                    + (4 * p if gae else 0)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                chain_ms = (t * RETURNS_CHAIN_OPS[gae]
                            * RETURNS_OP_CYCLES[dtype] / SM_CLOCK_HZ * 1e3)
                bound_ms = max(bytes_ms, chain_ms)
                key = (p, t) if mode == "discounted f32" else \
                    f"{p}x{t} {mode}"
                times["returns"][key] = dict(
                    ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="bytes" if bytes_ms >= chain_ms
                    else "operations")
                print(f"returns P={p} T={t} {mode}: kernel == plain loops "
                      f"(max abs err {err:.1e}), 2 launches counted; kernel "
                      f"{k_ms:.4f} ms (median of 7), plain loops "
                      f"{plain_ms:.1f} ms (1 run), bound "
                      f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB -> "
                      f"{bytes_ms * 1e3:.2f} us; chain "
                      f"{RETURNS_CHAIN_OPS[gae]} ops x "
                      f"{RETURNS_OP_CYCLES[dtype]} cycles x {t} steps -> "
                      f"{chain_ms * 1e3:.2f} us), {bound_ms / k_ms:.1%} of "
                      f"the bound")

    def same_run(a, b, what):
        """Two training results equal bit for bit: weights, Adam states,
        env rows and logs."""
        (ts_a, rows_a, log_a), (ts_b, rows_b, log_b) = a, b
        for x, y in zip([*ts_a.actor.parameters(), *ts_a.critic.parameters()],
                        [*ts_b.actor.parameters(), *ts_b.critic.parameters()]):
            assert torch.equal(x, y), f"{what}: weights differ"
        for o_a, o_b in ((ts_a.actor_opt, ts_b.actor_opt),
                         (ts_a.critic_opt, ts_b.critic_opt)):
            for s_a, s_b in zip(o_a.state.values(), o_b.state.values()):
                for k in s_a:
                    assert torch.equal(s_a[k], s_b[k]), \
                        f"{what}: Adam {k} differs"
        for x, y in zip(rows_a.fields(), rows_b.fields(), strict=True):
            assert torch.equal(x, y), f"{what}: env rows differ"
        assert log_a.logs == log_b.logs, f"{what}: logs differ"

    main_argv = ["-np", "1024", "-se", "0", "--output-root", out_dir,
                 "--fused-collect", "--fused-updates"]

    # ------------------------------------------------------------------
    phase("12. the main path as CUDA graphs: cli --jit-repeats 2, and with "
          "--pipeline-repeats, 4 repeats, against the eager loop")
    # Blocks of 2: the first eager (it builds and warms everything), the
    # second captured once and replayed (with --pipeline-repeats: one
    # repeat captured and replayed twice).  Each is held bit for bit
    # against 4 single eager repeats; the launch counters count replays.
    graph_runs = {}
    for label, extra in (("eager", []),
                         ("--jit-repeats 2", ["--jit-repeats", "2"]),
                         ("--jit-repeats 2 --pipeline-repeats",
                          ["--jit-repeats", "2", "--pipeline-repeats"])):
        reset_counts()
        t0 = time.perf_counter()
        result = cli(main_argv + ["-nt", str(4 * 1024 * 1000)] + extra)
        torch.cuda.synchronize()
        counts_ = read_counts()
        print(f"{label}: 4 repeats in {time.perf_counter() - t0:.2f} s; "
              f"kernel launches {counts_}")
        assert counts_ == expect(fused_collect=4, fused_actor_grad=200,
                                 fused_critic_grad=200, returns=4), counts_
        graph_runs[label] = result
    for label, result in graph_runs.items():
        if label != "eager":
            same_run(graph_runs["eager"], result, label)
            print(f"{label}: weights, Adam states, env rows and logs equal "
                  f"the eager run bit for bit")
    eager4 = graph_runs["eager"]  # phase 18 holds --num-data 1 against it
    del graph_runs, result

    # ------------------------------------------------------------------
    phase("13. times, eager against graphed: the collect tail and a fused "
          "repeat, and the device's busy share of a graphed repeat")
    # Medians of 5 of the device time (CUDA events), the host's enqueue and
    # wall time.  The tail is the collect less its kernel.  The busy share
    # of an unprofiled graphed repeat: the device time of its kernels, as a
    # profiled replay of the same graph sums them, over the unprofiled
    # replay's wall time; beside it, its CUDA-event span over that wall.
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler)
    ts, es = mappo.init(make_generator(0, dev))
    rows = fc.env_state_to_rows(es)
    seed = torch.tensor(200, dtype=torch.int32, device=dev)

    def repeat_fn():
        return mappo.train_many(ts, rows, None, 1,
                                lambda ts_, rows_, _: collect(ts_, rows_,
                                                              seed))

    work = {"kernel": lambda: collect.run_kernel(ts, rows, seed),
            "collect": lambda: collect(ts, rows, seed), "repeat": repeat_fn}
    graphs, graph_times = {}, {}
    for name, fn in work.items():
        fn()  # warm
        graphs[name] = CountedGraph()
        with graphs[name].capture():
            fn()
    eager_times = {name: timed(fn, reps=5) for name, fn in work.items()}
    graph_times = {name: timed(g.replay, reps=5) for name, g in graphs.items()}
    record["graphs_ms"] = {}
    for route, tm_ in (("eager", eager_times), ("graphed", graph_times)):
        tail = {k: tm_["collect"][k] - tm_["kernel"][k] for k in tm_["kernel"]}
        rep = tm_["repeat"]
        print(f"{route}: collect tail device {tail['device']:.3f} ms, host "
              f"enqueue {tail['enqueue']:.3f} ms, host wall "
              f"{tail['wall']:.3f} ms; repeat device {rep['device']:.3f} ms, "
              f"host enqueue {rep['enqueue']:.3f} ms, host wall "
              f"{rep['wall']:.3f} ms = "
              f"{1024 * 1000 / rep['wall'] * 1e3:,.0f} env-steps/s (medians "
              f"of 5)")
        record["graphs_ms"][route] = {"tail": tail, **tm_}
    prof_g = profile_run("profiled graphed repeat (one replay)",
                         graphs["repeat"].replay)
    record["breakdown_default"] = trace_breakdown(
        "the default graphed repeat (one replay), by kernel",
        graphs["repeat"].replay, os.path.join(out_dir, "trace_default"))
    wall_g = graph_times["repeat"]["wall"]
    busy_g = prof_g["device_busy_ms"]
    # Where the profile of a replay lists no collect kernel (the eager
    # profile above does), its time is taken from the collect kernel's own
    # graph, timed by CUDA events.
    if not any("fused_collect_kernel" in k for k in prof_g["ours"]):
        busy_g += graph_times["kernel"]["device"]
        print(f"the replay's profile lists no collect kernel: its graph's "
              f"{graph_times['kernel']['device']:.3f} ms (CUDA events) "
              f"added")
    share = busy_g / wall_g
    print(f"unprofiled graphed repeat: wall {wall_g:.3f} ms; its kernels "
          f"{busy_g:.3f} ms = {share:.1%} busy; CUDA-event span "
          f"{graph_times['repeat']['device']:.3f} ms = "
          f"{graph_times['repeat']['device'] / wall_g:.1%}")
    record["graphed_busy"] = {"wall_ms": wall_g, "profile": prof_g,
                              "busy_ms": busy_g, "share": share}
    assert all(math.isfinite(v) for v in
               (prof_g["wall_ms"], wall_g, graph_times["repeat"]["device"]))

    # The profiling hooks (utils/profiling.py) in use: 5 graphed replays
    # metered by Throughput beside the CUDA-event timing above, one trace
    # of a replay written under --out with its kernels printed by name,
    # and checked_step on one eager plain env step at P 1024 (passes) and
    # on the same step from a state holding an injected NaN (raises).
    with Throughput() as meter:
        for _ in range(5):
            graphs["repeat"].replay()
            meter.tick(1024 * 1000, rows.px)
    print(f"Throughput, 5 graphed replays: {meter.rate:,.0f} env-steps/s; "
          f"by the replays' median host wall above "
          f"{1024 * 1000 / wall_g * 1e3:,.0f}")
    trace_dir = os.path.join(out_dir, "trace")
    with trace(trace_dir) as prof_t:
        with annotate("graphed repeat"):
            graphs["repeat"].replay()
            torch.cuda.synchronize()
    traced = sorted(os.listdir(trace_dir))
    kernels_t = sorted({e.key.split("(")[0][:60] for e in
                        prof_t.key_averages()
                        if e.device_type == DeviceType.CUDA})
    print(f"trace of one replay: {traced} under {trace_dir}; its "
          f"{len(kernels_t)} device operations by name: {kernels_t}")
    assert traced and any(k.endswith(".pt.trace.json") for k in traced)
    env_c = make_env(cfg.env, cfg.init, dev)
    state_c = env_c.init(make_generator(0, dev))
    still = torch.zeros((1024, 3, 2), device=dev)
    err, (_, out_c) = checked_step(env_c.step)(state_c, still)
    assert err.get() is None and bool(torch.isfinite(out_c.rewards).all())
    bad = dataclasses.replace(state_c, states=state_c.states.clone())
    bad.states[5, 1, 0] = float("nan")
    err, _ = checked_step(env_c.step)(bad, still)
    try:
        err.throw()
        raise AssertionError("checked_step let an injected NaN through")
    except FloatingPointError as caught:
        print(f"checked_step: a clean env step at P 1024 passes; with a NaN "
              f"injected into one agent's x: {caught}")
    record["profiling_hooks"] = {"throughput_env_steps_s": meter.rate,
                                 "trace_files": traced,
                                 "trace_device_ops": kernels_t}
    del graphs

    # ------------------------------------------------------------------
    phase("14. checkpoint and resume on the card, the main path: 2 repeats "
          "with --checkpoint-dir, then --resume for a third, against 3")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    straight = cli(main_argv + ["-nt", str(3 * 1024 * 1000)])
    cli(main_argv + ["-nt", str(2 * 1024 * 1000), "--checkpoint-dir",
                     ckpt_dir])
    resumed = cli(main_argv + ["-nt", str(3 * 1024 * 1000),
                               "--checkpoint-dir", ckpt_dir, "--resume"])
    torch.cuda.synchronize()
    same_run(straight, resumed, "resume")
    print(f"2 repeats, checkpoints {sorted(os.listdir(ckpt_dir))}, then a "
          f"resume for the third: weights, Adam states, env rows and logs "
          f"equal 3 straight repeats bit for bit")
    del straight, resumed

    # ------------------------------------------------------------------
    phase("15. --bf16-updates on the card: the bf16 kernels against their "
          "plain versions, the main path trained (graphed, sliced, packed, "
          "wide), and times beside float32")
    # Each bf16 kernel (--bf16-updates: the affine actor's tiled and
    # staged roundings, the critic, the un-collapsed actor) against its
    # plain version in bf16 mode on the same inputs, output by output:
    # |kernel - plain_bf16| <= 1/4 |plain_bf16 - plain_f32| (max norms);
    # an output the rounding does not reach (the tiled actor's loss: its
    # forward is unrounded) within 1e-4 of its magnitude (+1e-7).  Beside
    # it, each output's error against float64 products of the same
    # bf16-rounded operands (acc=float64): for the tensor-core kernels,
    # their float32 accumulation alone.  Two launches bitwise equal.  On
    # phase 6's inputs (the default widths: the full batch of a real
    # collect and -bs 250 slice 0) and at H 256 and In 102 (phase 6's
    # random rows).
    for name, modes in bf16_modes.items():
        for mode in modes:
            check16(name, mode, "P=1024 T=1000 full batch", main_inputs[name])
            check16(name, mode, "-bs 250 slice 0", main_slice_inputs[name])
    for name, agents, f, h in (("fused_critic_grad", 3, 12, 256),
                               ("fused_critic_grad", 3, 34, 50),
                               ("fused_actor_grad_uncollapsed", 1, 12, 256),
                               ("fused_actor_grad_uncollapsed", 1, 34, 50),
                               ("fused_actor_grad", 1, 34, 50)):
        label, args = wide_case(name, agents, f, h)
        for mode in bf16_modes[name]:
            check16(name, mode, label, args)
    print(f"bf16 outputs outside the plain bf16 version's reach: "
          f"{len(misses)}" + "".join(f"\n  {m}" for m in misses))
    assert not misses, "phase 15: outputs outside the plain version's reach"

    # The main path at full width with --bf16-updates: 2 repeats through
    # the CLI (launch counts 2 / 100 / 100 / 0 / 0 / 2), then 4 eager
    # repeats against 4 with --jit-repeats 2 (an eager block, then a graphed
    # one), bit for bit; -bs 250 (the staged rounding) and
    # MARLNAV_ACTOR_LAYOUT=packed at -bs 250 (the un-collapsed kernel) for
    # a repeat each; -hs 256 and -no 14 for 2 short repeats on both actor
    # routes, as phase 9, and the widths with no bf16 instance, which take
    # the run-time-width route: -hs 32, -no 14 -hs 256 and -no 17 (with the
    # collect kernel's run-time instance).
    bf16_argv = main_argv + ["--bf16-updates"]

    def bf16_run(repeats, extra, want, label):
        reset_counts()
        t0 = time.perf_counter()
        result = cli(bf16_argv + ["-nt", str(repeats * 1024 * 1000)] + extra)
        torch.cuda.synchronize()
        counts_ = read_counts()
        logs_ = result[2].logs
        print(f"bf16 {label}: {repeats} repeat(s) in "
              f"{time.perf_counter() - t0:.2f} s; kernel launches {counts_}; "
              f"mean_rew {logs_['mean_rews']}; last losses actor "
              f"{logs_['actor'][-1]:.6f}, critic {logs_['critic'][-1]:.6f}")
        assert counts_ == want, (label, counts_)
        assert len(logs_["mean_rews"]) == repeats
        for key in ("mean_rews", "actor", "critic"):
            assert all(math.isfinite(v) for v in logs_[key]), (label, key)
        return result, counts_

    _, record["bf16"]["launches"] = bf16_run(
        2, [], expect(fused_collect=2, fused_actor_grad=100,
                      fused_critic_grad=100, returns=2), "main path")
    runs16 = {label: bf16_run(4, extra, expect(
                  fused_collect=4, fused_actor_grad=200, fused_critic_grad=200,
                  returns=4), label)[0]
              for label, extra in (("eager", []),
                                   ("--jit-repeats 2",
                                    ["--jit-repeats", "2"]))}
    same_run(runs16["eager"], runs16["--jit-repeats 2"], "bf16 graphed")
    print("bf16 --jit-repeats 2: weights, Adam states, env rows and logs "
          "equal the eager run bit for bit")
    del runs16
    bf16_run(1, ["-bs", "250"], expect(
        fused_collect=1, fused_actor_grad=200, fused_critic_grad=200,
        returns=1), "-bs 250 (staged rounding)")
    os.environ["MARLNAV_ACTOR_LAYOUT"] = "packed"
    try:
        bf16_run(1, ["-bs", "250"], expect(
            fused_collect=1, fused_critic_grad=200,
            fused_actor_grad_uncollapsed=200, returns=1),
            "-bs 250, MARLNAV_ACTOR_LAYOUT=packed")
    finally:
        del os.environ["MARLNAV_ACTOR_LAYOUT"]
    for extra, fused_collect in (
            (["-hs", "256"], True), (["-no", "14"], False),
            (["-hs", "32"], True), (["-no", "14", "-hs", "256"], True),
            (["-no", "17"], True)):
        for layout, bs in ((None, wt), ("packed", wt // 2)):
            wcfg = resolve_run_config(build_parser().parse_args(
                ["-np", str(wp), "-bl", str(wt), "-bs", str(bs), "-ne",
                 str(epochs), "-nt", str(2 * wp * wt), "-se", "0",
                 "--output-root", out_dir, "--fused-updates",
                 "--bf16-updates"] + extra))
            if layout:
                os.environ["MARLNAV_ACTOR_LAYOUT"] = layout
            try:
                reset_counts()
                _, _, wlog = train(wcfg, device="cuda",
                                   fused_collect=fused_collect,
                                   output_root=out_dir, verbose=False)
                torch.cuda.synchronize()
                wide_launches = read_counts()
            finally:
                os.environ.pop("MARLNAV_ACTOR_LAYOUT", None)
            grads = 2 * epochs * (wt // bs)
            actor_kernel = ("fused_actor_grad_uncollapsed" if layout
                            else "fused_actor_grad")
            label = (f"bf16 {' '.join(extra)}, "
                     f"{'un-collapsed' if layout else 'affine'} actor, -bs "
                     f"{bs}" + ("" if fused_collect else ", plain collect"))
            print(f"{label}: kernel launches {wide_launches}; mean_rew "
                  f"{wlog.logs['mean_rews']}")
            assert wide_launches == expect(
                fused_collect=2 if fused_collect else 0, returns=2,
                fused_critic_grad=grads, **{actor_kernel: grads}), (
                    label, wide_launches)
            for key in ("mean_rews", "actor", "critic"):
                assert all(math.isfinite(v) for v in wlog.logs[key]), (
                    label, key)

    # Times: each bf16 kernel beside its float32 instance on the same
    # inputs (medians of 7 after 2 warm-ups, float32 first), at its path's
    # shapes; the bound takes the same bytes and operations, the
    # tensor-core kernels' at the bf16 rate.  Then one graphed bf16 repeat
    # beside a float32 one (medians of 5, as phase 13).
    for name, mode, key, args in (
            ("fused_actor_grad", "tiled", (1024, 1000),
             main_inputs["fused_actor_grad"]),
            ("fused_actor_grad", "staged", (1024, 250),
             main_slice_inputs["fused_actor_grad"]),
            ("fused_critic_grad", True, (1024, 1000),
             main_inputs["fused_critic_grad"]),
            ("fused_critic_grad", True, (1024, 250),
             main_slice_inputs["fused_critic_grad"]),
            ("fused_actor_grad_uncollapsed", True, (1024, 250),
             main_slice_inputs["fused_actor_grad_uncollapsed"])):
        kernel, plain = fns[name]
        n = args[rows_arg[name]].shape[0]
        f32_ms = cuda_ms(lambda: kernel(*args), reps=7, warmup=2)
        k_ms = cuda_ms(lambda: kernel(*args, mode), reps=7, warmup=2)
        plain_ms = cuda_ms(lambda: plain(*args, mode), reps=3, warmup=1)
        nbytes, ops = update_work(name, n, main_mcfg)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / (BF16_OPS_PER_S if name in TENSOR_CORE_WORK
                        else FP32_OPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        tag = f"bf16{'' if mode is True else ' ' + mode} {key[0]}x{key[1]}"
        times[name][tag] = dict(
            ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms, f32_ms=f32_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print(f"{name} {tag}: {n:,} rows, bf16 kernel {k_ms:.4f} ms, "
              f"float32 kernel {f32_ms:.4f} ms (medians of 7; "
              f"{f32_ms / k_ms:.2f}x), plain bf16 version {plain_ms:.3f} ms "
              f"(median of 3), bound {bound_ms * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB -> {bytes_ms * 1e3:.1f} us; "
              f"{ops / 1e9:.2f} GFLOP -> {ops_ms * 1e3:.1f} us in "
              f"{'bf16' if name in TENSOR_CORE_WORK else 'float32'}), "
              f"{bound_ms / k_ms:.1%} of the bound")
    seed16 = torch.tensor(300, dtype=torch.int32, device=dev)
    record["bf16"]["graphed_repeat_ms"] = {}
    for label, bf16 in (("float32", False), ("bf16", True)):
        mappo = make_mappo(dataclasses.replace(cfg.model, bf16_updates=bf16),
                           env, cfg.normalizer, cfg.scaler, False, True)
        ts, es = mappo.init(make_generator(0, dev))
        rows = fc.env_state_to_rows(es)

        def repeat16():
            return mappo.train_many(ts, rows, None, 1,
                                    lambda ts_, rows_, _: collect(ts_, rows_,
                                                                  seed16))
        repeat16()  # warm
        graph16 = CountedGraph()
        with graph16.capture():
            repeat16()
        tm16 = timed(graph16.replay, reps=5)
        record["bf16"]["graphed_repeat_ms"][label] = tm16
        print(f"graphed {label} repeat: device {tm16['device']:.3f} ms, host "
              f"wall {tm16['wall']:.3f} ms = "
              f"{1024 * 1000 / tm16['wall'] * 1e3:,.0f} env-steps/s (medians "
              f"of 5)")
        assert math.isfinite(tm16["wall"])
        del graph16

    # ------------------------------------------------------------------
    phase("16. the diagnostics modes on the card: -rc, the trajectory of "
          "the trained actor, -re --save-animation")
    # The reward check through cli on the card, mock scenarios 0 and 1 at
    # 400 steps: its series against the reference goldens (target angles
    # and rewards at tests/test_cli_and_io.py:126-146's tolerances for
    # scenario 0; every series at tests/test_torch_env.py's golden ones,
    # rtol 2e-5 / atol 2e-3) and against the same run on the CPU.  These
    # modes run the env's plain step on the card, as the JAX package runs
    # env.step in a scan: no kernel launches.
    import numpy as np

    from marlnav_tpu_torch.diagnostics import Animation, rollout_trajectory

    record["diagnostics"] = {}
    goldens = os.path.join(here, "tests", "goldens")
    series_of = {"target_angles": ("target_angle", 0), "target_distances":
                 ("target_distance", 0), "obs_angles": ("obstacles_angles", 0),
                 "obs_distances": ("obstacles_distances", 0),
                 "angles_to_first": ("others_angles", 0),
                 "distances_to_first": ("others_distances", 0),
                 "angles_to_second": ("others_angles", 1),
                 "distances_to_second": ("others_distances", 1)}
    with contextlib.chdir(out_dir):
        for sn in (0, 1):
            argv = ["-rc", "-sn", str(sn), "-ms", "400"]
            reset_counts()
            t0 = time.perf_counter()
            card_series = cli(argv)
            card_s = time.perf_counter() - t0
            assert read_counts() == expect(), read_counts()
            cpu_series = cli(["--device", "cpu"] + argv)
            golden = dict(np.load(os.path.join(goldens, f"sn{sn}.npz")))
            worst = 0.0
            for key, (field, k) in series_of.items():
                want = golden[field][:, 0, 0, k]
                got = card_series[key]
                assert got.shape == (400,) and math.isfinite(float(
                    abs(got).max())), key
                rtol, atol = ((1e-5, 1e-5) if sn == 0 and key ==
                              "target_angles" else (2e-5, 2e-3))
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=f"sn{sn} {key} golden")
                np.testing.assert_allclose(got, cpu_series[key], rtol=2e-5,
                                           atol=2e-3,
                                           err_msg=f"sn{sn} {key} cpu")
                worst = max(worst, float(abs(got - want).max()))
            rtol, atol = (1e-5, 1e-3) if sn == 0 else (2e-5, 2e-3)
            np.testing.assert_allclose(card_series["rewards"],
                                       golden["rewards"][:, 0], rtol=rtol,
                                       atol=atol, err_msg=f"sn{sn} rewards")
            np.testing.assert_allclose(card_series["rewards"],
                                       cpu_series["rewards"], rtol=2e-5,
                                       atol=2e-3,
                                       err_msg=f"sn{sn} rewards cpu")
            rew_err = float(abs(card_series["rewards"]
                                - golden["rewards"][:, 0]).max())
            print(f"-rc -sn {sn} -ms 400 on the card: {card_s:.2f} s, no "
                  f"kernel launched; series against the golden: max abs err "
                  f"{worst:.3e} (observations), {rew_err:.3e} (rewards); the "
                  f"CPU run's within the golden tolerances too")
            record["diagnostics"][f"-rc -sn {sn}"] = dict(
                seconds=card_s, obs_err=worst, rewards_err=rew_err)

        # rollout_trajectory with the main path's trained actor (phase 4) at
        # the main configuration's width, 1024 envs x 1000 steps: the policy
        # mean (twice: equal bit for bit) and samples; the frames stacked on
        # the card and fetched once.  Its first 8 steps, mean, against the
        # same on the CPU.
        tr_env = make_env(EnvParams(num_parallel=1024),
                          TriangleInitConfig(num_parallel=1024), dev)
        tr_kw = dict(normalizer_cfg=norm, scaler_cfg=scal)
        assert not any(p_.device.type == "cpu"
                       for p_ in trained_actor.parameters())
        for sample in (False, True):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj = rollout_trajectory(tr_env, 1000, make_generator(5, dev),
                                      actor=trained_actor, sample=sample,
                                      **tr_kw)
            tr_s = time.perf_counter() - t0
            assert read_counts() == expect(), read_counts()
            assert traj.states.shape == (1000, 1024, 3, 5)
            assert all(np.isfinite(x).all() for x in (
                traj.states, traj.rewards, traj.obs.target_distance))
            label = "sampled" if sample else "policy mean"
            print(f"trajectory of the trained actor, {label}, 1024 envs x "
                  f"1000 steps on the card: {tr_s:.2f} s = "
                  f"{1024 * 1000 / tr_s:,.0f} env-steps/s (host wall, one "
                  f"fetch); mean reward {float(traj.rewards.mean()):.3f}, "
                  f"episodes ended {int(traj.terminated.sum())} + "
                  f"{int(traj.truncated.sum())} truncated")
            record["diagnostics"][f"trajectory {label}"] = dict(
                seconds=tr_s, env_steps_per_s=1024 * 1000 / tr_s)
            if not sample:
                again = rollout_trajectory(tr_env, 1000,
                                           make_generator(5, dev),
                                           actor=trained_actor, **tr_kw)
                assert (again.states == traj.states).all() and (
                    again.rewards == traj.rewards).all()
                print("  the policy mean's trajectory again: equal bit for "
                      "bit")

        # -re --save-animation: the GIF where matplotlib imports, else the
        # clear error.
        gif = os.path.join(out_dir, "anim.gif")
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ModuleNotFoundError:
            has_mpl = False
        reset_counts()
        if has_mpl:
            anim = cli(["-re", "-sn", "1", "-ms", "50", "--save-animation",
                        gif])
            assert isinstance(anim, Animation) and os.path.getsize(gif) > 0
            print(f"-re -sn 1 --save-animation: {os.path.getsize(gif):,} "
                  f"bytes written, {anim.traj.states.shape[0]} frames")
        else:
            try:
                cli(["-re", "-sn", "1", "-ms", "50", "--save-animation", gif])
                raise AssertionError("-re ran without matplotlib")
            except ModuleNotFoundError as err:
                assert "matplotlib" in str(err) and not os.path.exists(gif)
                print(f"-re without matplotlib: {err}")
        assert read_counts() == expect(), read_counts()

    # ------------------------------------------------------------------
    phase("17. the run-time gradient route on the training path at full "
          "size: -no 17, -hs 512, --bf16-updates -hs 64; a graphed repeat "
          "fused against autograd")
    # The defaults (P 1024, buffer 1000, full batch, 50 + 50 epochs) with
    # --fused-collect, at three widths whose critic has no tensor-core
    # instance (In 120 / H 50, In 36 / H 512, and in bf16 In 36 / H 64):
    # one repeat captured as a CUDA graph (as --jit-repeats runs it) on the
    # fused update route and on the autograd one, in the same call, its
    # kernel launches counted around its timed replays
    # (medians of 3: device ms by CUDA events, host wall ms, env-steps/s
    # by the wall).  Then -no 17 through the CLI: 4 eager repeats against
    # --jit-repeats 2 (an eager block, then a graphed one), bit for bit.
    record["runtime_training"] = {}
    for extra in (["-no", "17"], ["-hs", "512"],
                  ["--bf16-updates", "-hs", "64"]):
        label = " ".join(extra)
        by_route = {}
        for route in ("fused", "autograd"):
            rep = training_repeat(extra, out_dir, route == "fused", dev)
            rm = rep.cfg.model
            assert not lib.marlnav_critic_warps(rm.num_agents * rm.obs_size,
                                                rm.hidden_size,
                                                int(rm.bf16_updates))
            rep.run()  # warm
            graph17 = CountedGraph()
            with graph17.capture():
                rep.run()
            reset_counts()
            tm17 = timed(graph17.replay, reps=3)
            counts_ = read_counts()
            want = expect(fused_collect=3, returns=3, **(
                {"fused_actor_grad": 150, "fused_critic_grad": 150}
                if route == "fused" else {}))
            assert counts_ == want, (label, route, counts_)
            assert all(math.isfinite(v) for v in tm17.values())
            by_route[route] = tm17
            print(f"{label}, graphed {route} repeat: device "
                  f"{tm17['device']:.3f} ms, host wall {tm17['wall']:.3f} ms"
                  f" = {1024 * 1000 / tm17['wall'] * 1e3:,.0f} env-steps/s "
                  f"(medians of 3); launches in the 3 replays {counts_}")
            if route == "fused" and extra == ["-no", "17"]:
                # The collect's run-time instance inside this repeat: its
                # device time in a profiled replay, and its own graph's.
                prof17 = profile_run(f"{label}: profiled graphed repeat (one "
                                     "replay)", graph17.replay)
                in_repeat = [t_ for k_, (_, t_) in prof17["ours"].items()
                             if "fused_collect_rt_kernel" in k_]
                kgraph = CountedGraph()
                rep.collect.run_kernel(rep.ts, rep.rows, rep.seed)  # warm
                with kgraph.capture():
                    rep.collect.run_kernel(rep.ts, rep.rows, rep.seed)
                k17 = timed(kgraph.replay, reps=5)["device"]
                print(f"{label}: the collect kernel in the graphed repeat "
                      + (f"{in_repeat[0]:.3f} ms (the profiled replay)"
                         if in_repeat else "not listed by the profiler")
                      + f"; its own graph {k17:.3f} ms (CUDA events, median "
                      f"of 5) of the repeat's {tm17['device']:.3f}")
                record["runtime_training"]["-no 17 collect_ms"] = dict(
                    profiled=in_repeat[0] if in_repeat else None, graph=k17)
                del kgraph
            del graph17, rep
        print(f"{label}: autograd / fused repeat (host wall) "
              f"{by_route['autograd']['wall'] / by_route['fused']['wall']:.2f}"
              f"x")
        record["runtime_training"][label] = by_route
    argv17 = main_argv + ["-no", "17", "-nt", str(4 * 1024 * 1000)]
    runs17 = {}
    for label, extra in (("eager", []), ("--jit-repeats 2",
                                         ["--jit-repeats", "2"])):
        reset_counts()
        runs17[label] = cli(argv17 + extra)
        torch.cuda.synchronize()
        counts_ = read_counts()
        assert counts_ == expect(fused_collect=4, fused_actor_grad=200,
                                 fused_critic_grad=200, returns=4), counts_
    same_run(runs17["eager"], runs17["--jit-repeats 2"], "-no 17 graphed")
    print("-no 17, 4 repeats: --jit-repeats 2 equals the eager loop bit for "
          "bit (weights, Adam states, env rows, logs); launches 4 / 200 / "
          "200 / 0 / 0 / 4 each")
    del runs17

    # ------------------------------------------------------------------
    phase("18. --num-data 1 on the card: the main path over NCCL at one "
          "rank, eager and graphed, against the runs without it; the "
          "collectives counted and their cost timed")
    import torch.distributed as dist

    from marlnav_tpu_torch.parallel import init_distributed, make_mesh

    print(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    # 4 repeats through the CLI, eager and with --jit-repeats 2 (an eager
    # block, which creates NCCL's communicator, then a graphed one holding
    # the collectives), each bit for bit against phase 12's eager run
    # without --num-data, with its launch counts.
    for label, extra in (("eager", []),
                         ("--jit-repeats 2", ["--jit-repeats", "2"])):
        reset_counts()
        t0 = time.perf_counter()
        result = cli(main_argv + ["-nt", str(4 * 1024 * 1000),
                                  "--num-data", "1"] + extra)
        torch.cuda.synchronize()
        counts_ = read_counts()
        print(f"--num-data 1, {label}: 4 repeats in "
              f"{time.perf_counter() - t0:.2f} s; kernel launches {counts_}")
        assert counts_ == expect(fused_collect=4, fused_actor_grad=200,
                                 fused_critic_grad=200, returns=4), counts_
        same_run(eager4, result, f"--num-data 1 {label}")
        print(f"--num-data 1, {label}: weights, Adam states, env rows and "
              f"logs equal phase 12's eager run without it bit for bit")
    del result, eager4
    # One repeat on the autograd update route, with and without it.
    auto_argv = ["-np", "1024", "-se", "0", "--output-root", out_dir,
                 "--fused-collect", "-nt", str(1024 * 1000)]
    reset_counts()
    auto = [cli(auto_argv + extra) for extra in ([], ["--num-data", "1"])]
    torch.cuda.synchronize()
    counts_ = read_counts()
    assert counts_ == expect(fused_collect=2, returns=2), counts_
    same_run(auto[0], auto[1], "autograd --num-data 1")
    print(f"autograd route, 1 repeat: --num-data 1 equals the run without "
          f"it bit for bit; launches of both {counts_}")
    del auto
    # A repeat through the mesh's functions and phase 13's repeat without
    # a mesh, eager and as graphs, timed in turns here (medians of 5 eager
    # and of 7 graphed runs, the two alternated); the host's time of one
    # all-reduce; the collectives counted in a profiled eager repeat (the
    # host's calls) and a profiled replay (NCCL's device work).
    def in_turns(fns, reps):
        runs = {name: [] for name in fns}
        for _ in range(reps):
            for name, fn in fns.items():
                runs[name].append(timed(fn, reps=1))
        return {name: {k: statistics.median(r[k] for r in rs)
                       for k in rs[0]} for name, rs in runs.items()}

    mappo_n = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler)
    ts_n, es_n = mappo_n.init(make_generator(0, dev))
    rows_n = fc.env_state_to_rows(es_n)
    seed_m = torch.tensor(200, dtype=torch.int32, device=dev)

    def repeat_n():
        return mappo_n.train_many(ts_n, rows_n, None, 1,
                                  lambda t_, r_, _: collect(t_, r_, seed_m))

    repeat_n()
    graph_n = CountedGraph()
    with graph_n.capture():
        repeat_n()
    with tempfile.TemporaryDirectory() as rendezvous:
        init_distributed(num_processes=1, process_id=0, backend="nccl",
                         init_method="file://" + os.path.join(rendezvous,
                                                              "store"))
        try:
            mesh = make_mesh(device="cuda", local_rank=0, local_world=1)
            env_m = make_env(cfg.env, cfg.init, dev, mesh=mesh)
            mappo_m = make_mappo(cfg.model, env_m, cfg.normalizer,
                                 cfg.scaler, mesh=mesh)
            collect_m = fc.make_fused_collect(cfg.model, cfg.env, cfg.init,
                                              cfg.normalizer, cfg.scaler,
                                              mesh)
            ts_m, es_m = mappo_m.init(make_generator(0, dev))
            rows_m = fc.env_state_to_rows(es_m)

            def repeat_m():
                return mappo_m.train_many(
                    ts_m, rows_m, None, 1,
                    lambda t_, r_, _: collect_m(t_, r_, seed_m))

            repeat_m()  # warm: NCCL's communicator exists from here on
            graph_m = CountedGraph()
            with graph_m.capture():
                repeat_m()
            eager_tm = in_turns({"mesh": repeat_m, "none": repeat_n}, 5)
            graph_tm = in_turns({"mesh": graph_m.replay,
                                 "none": graph_n.replay}, 7)
            one = torch.zeros((), device=dev)
            reduce_100 = timed(lambda: [dist.all_reduce(one)
                                        for _ in range(100)], reps=3)
            prof_e = profile_run("profiled eager repeat, --num-data 1",
                                 repeat_m)
            prof_r = profile_run("profiled graphed repeat, --num-data 1 "
                                 "(one replay)", graph_m.replay)
            del graph_m, graph_n
        finally:
            dist.destroy_process_group()
    print(f"collectives a repeat: the host's calls in the eager repeat "
          f"{prof_e['host_collectives'] or 'not recorded by the profiler'};"
          f" NCCL's device work in the replay "
          f"{prof_r['nccl'] or 'none (one rank: in-place sums copy nothing)'}"
          f"; one all-reduce of a scalar: host "
          f"{reduce_100['enqueue'] * 10:.1f} us (100 in turn: enqueue "
          f"{reduce_100['enqueue']:.3f} ms, device {reduce_100['device']:.3f}"
          f" ms)")
    for label, tm_ in (("eager", eager_tm), ("graphed", graph_tm)):
        now, before = tm_["mesh"], tm_["none"]
        print(f"{label} repeat, --num-data 1: device {now['device']:.3f} ms, "
              f"host enqueue {now['enqueue']:.3f}, host wall "
              f"{now['wall']:.3f}; without a mesh, in turns with it: device "
              f"{before['device']:.3f}, enqueue {before['enqueue']:.3f}, "
              f"wall {before['wall']:.3f}; the collectives' cost at one "
              f"rank: device {now['device'] - before['device']:+.3f} ms, "
              f"wall {now['wall'] - before['wall']:+.3f} ms")
    print(f"phase 13 (without a mesh): eager repeat wall "
          f"{record['graphs_ms']['eager']['repeat']['wall']:.3f} ms, graphed "
          f"{record['graphs_ms']['graphed']['repeat']['wall']:.3f}; phase 4's "
          f"eager fused repeat (its phases' sum) wall "
          f"{record['phases_ms']['fused']['repeat']['wall']:.3f}")
    record["num_data_1"] = {"eager": eager_tm, "graphed": graph_tm,
                            "all_reduce_100": reduce_100,
                            "host_collectives": prof_e["host_collectives"],
                            "replay_nccl": prof_r["nccl"],
                            "replay_busy_ms": prof_r["device_busy_ms"]}
    assert all(math.isfinite(v) for tm_ in (eager_tm, graph_tm)
               for d in tm_.values() for v in d.values())

    # ------------------------------------------------------------------
    phase("19. two ranks on this card over gloo: the fused route with "
          "injected noise against one rank, the sharded bench rollout "
          "against one-process rollouts of each rank's envs")
    from marlnav_tpu_torch.ops.fused_collect import shard_seed
    from marlnav_tpu_torch.parallel.launch import run_local_ranks

    dir19 = os.path.join(out_dir, "phase19")
    os.makedirs(dir19, exist_ok=True)
    one = phase19_fused(None, dev)
    t0 = time.perf_counter()
    run_local_ranks(2, "gloo", phase19_rank, dir19)
    print(f"2 ranks (rank 1 spawned) over gloo on {dev}: "
          f"{time.perf_counter() - t0:.1f} s")
    ranks19 = [torch.load(os.path.join(dir19, f"rank{r}.pt"),
                          weights_only=False) for r in range(2)]
    err19 = {}
    for i, want in enumerate(one["rows"]):
        got = torch.cat([r["rows"][i] for r in ranks19], -1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        err19["rows"] = max(err19.get("rows", 0.0),
                            (got - want).abs().max().item())
    for rank, r in enumerate(ranks19):
        print(f"rank {rank}: kernel launches {r['launches']}; mean_rew "
              f"{r['mean_rew']} (one rank: {one['mean_rew']})")
        assert r["launches"] == expect(fused_collect=1, fused_actor_grad=5,
                                       fused_critic_grad=5, returns=1)
        for key in ("al", "cl"):
            torch.testing.assert_close(r[key], one[key], rtol=1e-4,
                                       atol=1e-5)
            err19[key] = (r[key] - one[key]).abs().max().item()
        for got, want in zip(r["weights"], one["weights"]):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            err19["weights"] = max(err19.get("weights", 0.0),
                                   (got - want).abs().max().item())
    print(f"2 ranks against 1 at P {P19}, T {T19}, 5 + 5 epochs: largest "
          f"differences {err19} (rows rtol 1e-5 / atol 1e-3; losses and "
          f"weights rtol 1e-4 / atol 1e-5)")
    ep19, icfg19, rows19, actor19 = phase19_rollout_inputs(dev)
    roll19 = fr.make_fused_rollout(ep19, icfg19, norm, scal, ROLL19[1])
    half = ROLL19[0] // 2
    for rank, r in enumerate(ranks19):
        cols = fc.RowState(*(x[:, rank * half:(rank + 1) * half]
                             .contiguous() for x in rows19.fields()))
        final, rewards = roll19(cols, actor19, shard_seed(9, rank))
        got_rewards, got_rows = r["rollout"]
        assert torch.equal(got_rewards, rewards.cpu()), rank
        assert all(torch.equal(x, y.cpu()) for x, y in
                   zip(got_rows, final.fields())), rank
    print(f"sharded rollout {ROLL19[0]} x {ROLL19[1]}, {half} envs a rank: "
          f"each rank's rewards and final rows equal a one-process rollout "
          f"of its envs at seed 9 + (rank << 20) bit for bit")
    record["two_ranks_gloo"] = {"max_abs_err": err19,
                                "launches": [r["launches"] for r in ranks19]}
    del ranks19

    # ------------------------------------------------------------------
    phase("20. --num-model on this card over gloo: 1 x 2 on the fused and "
          "the autograd routes, 2 x 2 and -hs 512 on the autograd route, "
          "each against one process")
    ones = {("fused", 50): one}  # phase 19's one-process run
    for route, hidden in (("autograd", 50), ("autograd", 512)):
        ones[(route, hidden)] = phase20_result(None, dev, route, hidden)
    ranks20 = {}
    for world in (2, 4):
        dir20 = os.path.join(out_dir, f"phase20_{world}")
        os.makedirs(dir20, exist_ok=True)
        t0 = time.perf_counter()
        run_local_ranks(world, "gloo", phase20_rank, dir20, 2)
        ranks20[world] = [torch.load(os.path.join(dir20, f"rank{r}.pt"),
                                     weights_only=False)
                          for r in range(world)]
        print(f"{world} ranks ({ranks20[world][0]['grid']}, ranks 1 .. "
              f"{world - 1} spawned) over gloo on {dev}: "
              f"{time.perf_counter() - t0:.1f} s")
    err20 = {}
    for world, ranks in ranks20.items():
        grid = ranks[0]["grid"]
        for route, hidden in P20_CASES[grid]:
            want = ones[(route, hidden)]
            label = f"{grid} {route} -hs {hidden}"
            err = {}
            for rank, r in enumerate(ranks):
                got = r[(route, hidden)]
                assert got["launches"] == (expect(
                    fused_collect=1, fused_actor_grad=5, fused_critic_grad=5,
                    returns=1) if route == "fused" else expect(returns=1)), (
                    label, rank, got["launches"])
                np.testing.assert_allclose(got["mean_rew"], want["mean_rew"],
                                           rtol=1e-5, err_msg=label)
                for key in ("al", "cl"):
                    torch.testing.assert_close(got[key], want[key],
                                               rtol=1e-4, atol=1e-5)
                    err[key] = max(err.get(key, 0.0),
                                   (got[key] - want[key]).abs().max().item())
                for x, y in zip(got["weights"], want["weights"]):
                    torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
                    err["weights"] = max(err.get("weights", 0.0),
                                         (x - y).abs().max().item())
                # The ranks of a model group step the same envs with the
                # same draws: their states are equal bit for bit.
                first = ranks[rank - r["model"]][(route, hidden)]
                assert all(torch.equal(x, y) for x, y in
                           zip(got["rows"], first["rows"])), (label, rank)
            # The data indices' envs together are one process's.
            for i, x in enumerate(want["rows"]):
                cat = torch.cat([r[(route, hidden)]["rows"][i] for r in ranks
                                 if r["model"] == 0], -1 if route == "fused"
                                else 0)
                torch.testing.assert_close(cat, x, rtol=1e-5, atol=1e-3)
                err["rows"] = max(err.get("rows", 0.0),
                                  (cat - x).abs().max().item())
            err20[label] = err
            print(f"{label}: every rank's kernel launches "
                  f"{ranks[0][(route, hidden)]['launches']}; largest "
                  f"differences from one process {err} (rows rtol 1e-5 / "
                  f"atol 1e-3; losses and weights rtol 1e-4 / atol 1e-5); "
                  f"collectives of the repeat (rank 0): "
                  f"{ranks[0][(route, hidden)]['collectives']}")
    timed20 = ranks20[2][0]["timed"]
    for route, tm_ in timed20.items():
        now, before = tm_["mesh"], tm_["one"]
        print(f"eager {route} repeat at 1 x 2 over gloo (rank 0): host wall "
              f"{now['wall']:.3f} ms, device {now['device']:.3f}; one "
              f"process, in turns: wall {before['wall']:.3f}, device "
              f"{before['device']:.3f} ({now['wall'] / before['wall']:.2f}x "
              f"the wall)")
    for label, tm_ in ranks20[2][0]["all_reduce_100"].items():
        print(f"100 model-group all-reduces of the {label} over gloo at 1 x "
              f"2 (rank 0): host wall {tm_['wall']:.3f} ms, "
              f"{tm_['wall'] * 10:.1f} us each")
    record["num_model_gloo"] = {
        "max_abs_err": err20, "timed": timed20,
        "all_reduce_100": ranks20[2][0]["all_reduce_100"],
        "collectives": {f"{r['grid']} {k[0]} -hs {k[1]}": r[k]["collectives"]
                        for ranks in ranks20.values() for r in ranks[:1]
                        for k in P20_CASES[r["grid"]]},
        "launches": {f"{r['grid']} {k[0]} -hs {k[1]}": r[k]["launches"]
                     for ranks in ranks20.values() for r in ranks[:1]
                     for k in P20_CASES[r["grid"]]}}
    del ranks20, ones, one

    # ------------------------------------------------------------------
    phase("21. the curriculum on the card: the JAX package's seed-42 "
          "radius-30 state resumed, mean-eval, the update kernels in the "
          "trained regime, H42's first stage, a stage from scratch, the "
          "renderer's statistics, the quick sweep")
    from marlnav_tpu_torch.ops import _build
    from marlnav_tpu_torch.ops.step_math import StepMath
    from marlnav_tpu_torch.scripts import curriculum as cur
    from marlnav_tpu_torch.scripts import render_curriculum as rcur
    from marlnav_tpu_torch.scripts import sweep as swp
    from marlnav_tpu_torch.utils.jax_state import load_jax_state

    docs = os.path.join(here, "docs")
    state21 = os.path.join(docs, "curriculum_r5s42_state.pkl")
    with open(os.path.join(docs, "curriculum_r5s42_radius_noise_adaptive"
                           ".json")) as fh:
        s42 = json.load(fh)
    jax1, jax31 = s42[0], s42[-1]  # from scratch; the state's own stage
    with open(os.path.join(docs, "curriculum_r5s42b_radius_noise_adaptive"
                           ".json")) as fh:
        jax32 = json.load(fh)[0]  # H42's first stage, 32
    rec21 = {}
    # (a) The state, through the restricted unpickler (no JAX package).
    nvcc_before = _build.load_libraries.nvcc_runs
    ts21, rows21, sched21 = load_jax_state(state21, dev)
    steps21 = {float(s["step"]) for o in (ts21.actor_opt, ts21.critic_opt)
               for s in o.state.values()}
    step_devs = {(s["step"].device.type, s["step"].dtype)
                 for o in (ts21.actor_opt, ts21.critic_opt)
                 for s in o.state.values()}
    print(f"(a) {state21}: schedule {sched21}; Adam steps {steps21} "
          f"({step_devs}); variance head bias "
          f"{ts21.actor.fc_var.bias.tolist()}")
    assert sched21["radius"] == 30.0 and sched21["ent"] == 5e-4 \
        and sched21["gr"] == 18600 and sched21["stage"] == 31, sched21
    assert steps21 == {174000.0} and step_devs == {("cuda",
                                                    torch.float32)}
    rec21["schedule"] = sched21
    # (b) Mean-eval from the pickled rows at H42's stage constants.
    p21, t21 = cur.P_ADAPTIVE, cur.T_ADAPTIVE
    ep21 = EnvParams(num_parallel=p21, risk_factor=250.0,
                     target_factor=500_000.0, target_radius=30.0,
                     group_soft_factor=50_000.0, episode_len=400,
                     staggered_resets=True)
    icfg21 = TriangleInitConfig(num_parallel=p21, num_obstacles=3)
    reset_counts()
    mean_tar21 = cur.mean_eval(ep21, icfg21, t21, rows21, ts21.actor,
                               500_000.0, dev)
    assert read_counts() == expect(fused_rollout=1), read_counts()
    sm21 = StepMath(ep21, icfg21, norm, scal)
    a21, c21 = fc._affine_compose(ts21.actor)
    u21 = torch.rand((t21, sm21.n_draws, p21), device=dev,
                     generator=make_generator(0, dev))
    k21 = fr.fused_rollout_rows(sm21, rows21, a21, c21, 0, t21, True, u21)
    r21 = fr.rollout_rows_reference(sm21, rows21, a21, c21, u21, True)
    err21 = max((x - y).abs().max().item() for x, y in
                zip((k21[1], *k21[0].fields()), (r21[1], *r21[0].fields())))
    injected21 = int((k21[1] > 250_000.0).sum())
    print(f"(b) policy-mean rollout, {p21} x {t21} from the pickled rows: "
          f"mean_tar {mean_tar21} (kernel's Philox stream, seed 0); JAX "
          f"record {jax31['mean_tar']} at stage 31, {jax32['mean_tar']} at "
          f"stage 32. On uniforms drawn on the card (seed 0): kernel == "
          f"plain version, max abs err {err21:.3e} (rewards and final "
          f"rows), mean_tar {injected21}")
    assert err21 == 0.0, err21
    rec21["mean_tar"] = {"philox": mean_tar21, "injected": injected21,
                         "kernel_vs_plain": err21}
    # (c) The update kernels in the trained regime: one buffer collected
    # from the state, the first minibatch step of its actor and critic
    # phases, each output (its sum over the rows) against the float32
    # plain version within phase 6's bound (1e-4 of the output's largest
    # magnitude, + 1e-7), and against the float64 one within that bound,
    # or, where the float32 plain version itself misses it, within the
    # bound of that version's own error.  At a policy variance near 4e-6 an
    # action lies ~2e-3 from its mean, and a float32 action (ulp ~6e-8)
    # carries that offset to ~3e-5: the ratios, hence the actor's sums,
    # are set by float32 rounding in any float32 arithmetic.
    cfg21 = cur.build_cfg(p21, t21, ent_const=5e-4)
    collect21 = fc.make_fused_collect(cfg21, ep21, icfg21, norm, scal)
    _, buf21, met21 = collect21(ts21, rows21, ((42 * 1_000_003) % (1 << 30))
                                + 18600)
    ended21 = [int(x) for x in (met21.stats.num_tar, met21.stats.num_col,
                                met21.stats.num_trunc)]
    print(f"(c) a buffer collected from the state: episodes ended "
          f"{ended21} (reaches, collisions, truncations)")
    rec21["kernel_errors"] = {}
    for name, args in (("fused_actor_grad",
                        update_args("fused_actor_grad", ts21.actor, buf21,
                                    cfg21)),
                       ("fused_critic_grad",
                        update_args("fused_critic_grad", ts21.critic,
                                    buf21, cfg21))):
        kernel, plain = fns[name]
        n = args[rows_arg[name]].shape[0]
        k, p32 = kernel(*args), plain(*args)
        p64 = plain(*(x.double() if torch.is_tensor(x) else x
                      for x in args))
        per_output = {}
        for out_name, kv, q, w in zip(outputs[name], k, p32, p64):
            w = w / n
            ek = (kv.double() / n - w).abs().max().item()
            ep_ = (q.double() / n - w).abs().max().item()
            ekp = (kv.double() - q.double()).abs().max().item() / n
            tol = 1e-4 * w.abs().max().item() + 1e-7
            per_output[out_name] = dict(kernel_f64=ek, plain_f32_f64=ep_,
                                        kernel_plain=ekp, bound=tol)
        print(f"    {name}, {n:,} rows: per output, error of the kernel / "
              f"of the plain float32 version against float64, the kernel "
              f"against the plain float32 version (bound): " + ", ".join(
                  f"{o} {e['kernel_f64']:.2e} / {e['plain_f32_f64']:.2e}, "
                  f"{e['kernel_plain']:.2e} ({e['bound']:.2e})"
                  for o, e in per_output.items()))
        for o, e in per_output.items():
            assert e["kernel_plain"] <= e["bound"], (name, o, e)
            assert e["kernel_f64"] <= max(e["bound"], e["plain_f32_f64"]) \
                + e["bound"], (name, o, e)
        rec21["kernel_errors"][name] = per_output
    # (c2) The stage's blocks of 25 repeats: the graphed block equals the
    # eager loop bit for bit, and a restore copies the snapshot back into
    # the tensors the graph read.
    from marlnav_tpu_torch.train import _Blocks

    mappo21, collect21 = cur.stage_functions(cfg21, ep21, icfg21, dev)
    snap21 = cur.Snapshot.take(ts21, rows21)
    base21 = (42 * 1_000_003) % (1 << 30)

    def live21(rows):
        return [x.detach().clone() for x in (
            *ts21.actor.parameters(), *ts21.critic.parameters(),
            *rows.fields())]

    reset_counts()
    rows_g, packed_g = cur.run_repeats(mappo21, collect21, ts21, rows21,
                                       2 * cur.BLOCK, base21, 18600, dev)
    graphed21 = live21(rows_g)
    assert read_counts()["fused_collect"] == 2 * cur.BLOCK, read_counts()
    snap21.restore(ts21, rows21)
    assert all(torch.equal(x, y) for x, y in zip(
        live21(rows21), [*snap21.actor.values(), *snap21.critic.values(),
                          *snap21.rows]))
    seeds21 = torch.zeros(cur.BLOCK, dtype=torch.int32, device=dev)
    blocks21 = _Blocks(mappo21, ts21, None,
                       lambda ts_, r_, i: collect21(ts_, r_, seeds21[i]),
                       seeds21, torch.arange(cur.BLOCK, dtype=torch.int32,
                                             device=dev),
                       base21, cur.BLOCK, pipeline=True)
    rows_e, packed_e = rows21, []
    for b in range(2):
        rows_e, out = blocks21.eager(rows_e, 18600 + b * cur.BLOCK,
                                     cur.BLOCK)
        packed_e.append(out.cpu().numpy())
    same21 = all(torch.equal(x, y) for x, y in zip(graphed21,
                                                   live21(rows_e)))
    print(f"(c2) 2 blocks of {cur.BLOCK} repeats from the state, the second "
          f"a graph's replays, against 2 eager blocks after a restore: "
          f"networks and rows equal bit for bit: {same21}; counts equal: "
          f"{bool((packed_g == np.concatenate(packed_e)).all())}")
    assert same21 and (packed_g == np.concatenate(packed_e)).all()
    # (c3) One repeat at H42's constants (4096 x 200, 10 + 10 epochs, GAE)
    # captured as a graph and traced, beside phase 13's default repeat.
    seed21 = torch.tensor(base21, dtype=torch.int32, device=dev)

    def h42_repeat():
        return mappo21.train_many(ts21, rows21, None, 1,
                                  lambda ts_, r_, _: collect21(ts_, r_,
                                                               seed21))

    h42_repeat()  # warm
    graph21 = CountedGraph()
    with graph21.capture():
        h42_repeat()
    rec21["breakdown"] = trace_breakdown(
        "(c3) a graphed repeat at H42's constants (one replay), by kernel",
        graph21.replay, os.path.join(out_dir, "trace_h42"))
    snap21.restore(ts21, rows21)
    del buf21, collect21, k21, r21, u21, mappo21, blocks21, snap21, graph21
    # (d) H42's first stage (docs/curriculum_r5.md:255-268), one stage.
    h42 = ["--mode", "radius-noise-adaptive", "--seed", "42",
           "--repeats-per-stage", "600", "--group-soft", "50000",
           "--episode-len-small", "400", "--mean-eval",
           "--coarse-threshold", "0.01", "--fine-threshold", "0.01",
           "--consolidate", "20"]
    reset_counts()
    t0 = time.perf_counter()
    hist = cur.main(h42 + ["--resume-state", state21, "--max-stages", "32",
                           "--out", os.path.join(out_dir, "h42")])
    torch.cuda.synchronize()
    h42_s = time.perf_counter() - t0
    launches21 = read_counts()
    stage32 = hist[0]
    env_steps = 600 * p21 * t21
    print(f"(d) H42 stage 32: tar_share {stage32['tar_share']:.4%} "
          f"(JAX record {jax32['tar_share']:.2%}), mean_tar "
          f"{stage32['mean_tar']} (JAX {jax32['mean_tar']}), radius "
          f"{stage32['radius']}, var_bias_mean {stage32['var_bias_mean']} "
          f"(JAX {jax32['var_bias_mean']}); {stage32['seconds']} s of "
          f"repeats (the record's 0.1 s), {h42_s:.6f} s with the resume "
          f"and the mean-eval: {env_steps / h42_s:,.0f} env-steps/s; "
          f"launches {launches21}")
    assert len(hist) == 1 and stage32["stage"] == 32 \
        and stage32["radius"] == 30.0, hist
    assert stage32["tar_share"] > 0.01, stage32  # the run's 1% gate
    assert launches21 == expect(fused_collect=600, fused_actor_grad=6000,
                                fused_critic_grad=6000, returns=1200,
                                fused_rollout=1), launches21
    assert _build.load_libraries.nvcc_runs == nvcc_before, \
        "nvcc ran during the curriculum"
    if not 0.04 <= stage32["tar_share"] <= 0.16:
        print(f"    tar_share {stage32['tar_share']:.4f} outside 4-16%")
    rec21["h42"] = {**stage32, "wall_s": h42_s,
                    "env_steps_per_s": env_steps / h42_s,
                    "launches": launches21}
    # (e) A stage from scratch at radius 300 (the RNGs differ from the
    # JAX package's, and ignition is seed-dependent: printed, not held).
    reset_counts()
    t0 = time.perf_counter()
    hist1 = cur.main(h42 + ["--max-stages", "1",
                            "--out", os.path.join(out_dir, "s42")])
    torch.cuda.synchronize()
    scratch_s = time.perf_counter() - t0
    print(f"(e) seed 42 stage 1 from scratch: tar_share "
          f"{hist1[0]['tar_share']:.4%} (JAX record {jax1['tar_share']:.2%}),"
          f" mean_tar {hist1[0]['mean_tar']} (JAX {jax1['mean_tar']}); "
          f"{hist1[0]['seconds']} s of repeats, {scratch_s:.3f} s in all; "
          f"launches {read_counts()}")
    assert _build.load_libraries.nvcc_runs == nvcc_before
    rec21["scratch"] = {**hist1[0], "wall_s": scratch_s}
    # (f) The renderer's statistics: the stage-31 actor at radius 30 on
    # 1024 envs, 400 steps (README: 130 of 1024 reach).
    buf_out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf_out):
            rcur.main(["--radius", "30", "--envs", "1024", "--steps", "400",
                       "--episode-len", "400", "--weights",
                       os.path.join(docs, "curriculum_r5s42_actor_stage31"
                                    ".npz"),
                       "--out", os.path.join(out_dir, "r5s42_r30.gif")])
        drawn = "animation written"
    except ModuleNotFoundError as err:
        assert "matplotlib" in str(err), err
        drawn = f"no animation ({err})"
    render_s = time.perf_counter() - t0
    stats21 = json.loads(buf_out.getvalue().splitlines()[0])
    print(f"(f) {json.dumps(stats21)}: {stats21['envs_with_group_reach']} "
          f"of 1024 envs reach (README: 130 of 1024); {render_s:.3f} s; "
          f"{drawn}")
    assert 0 < stats21["envs_with_group_reach"] <= 1024
    rec21["render"] = {**stats21, "seconds": render_s}
    # (g) The quick sweep, 20 repeats a cell.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cells = swp.main(["--grid", "quick", "--repeats", "20", "--out",
                          os.path.join(out_dir, "sweep_quick")])
    print(f"(g) sweep --grid quick --repeats 20: "
          f"{time.perf_counter() - t0:.3f} s")
    for c in cells:
        print("    " + json.dumps(c))
        assert all(math.isfinite(c[k]) for k in ("mean_rew_first",
                                                 "mean_rew_last"))
    rec21["sweep"] = cells
    assert _build.load_libraries.nvcc_runs == nvcc_before
    record["curriculum"] = rec21
    del ts21, rows21

    # ------------------------------------------------------------------
    phase("22. the hold against the JAX package (python -m "
          "marlnav_tpu_torch.scripts.hold), cut: ignition and "
          "ignition-jax-init on 2 of the 16 seeds, h42 on 2 of its 20 "
          "stages, the sweep on --grid quick --repeats 20 (not main at 300)")
    # Each check completes with every field finite; its launches are phase
    # 21's a repeat (1 collect, 10 + 10 gradient launches, 2 returns: GAE)
    # and a rollout a stage where it takes the mean-eval (h42); no nvcc.
    # The full checks run on their own (python -m
    # marlnav_tpu_torch.scripts.hold --check all; README).
    from marlnav_tpu_torch.scripts import hold as hld

    def finite_tree(x):
        if isinstance(x, dict):
            return all(finite_tree(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(finite_tree(v) for v in x)
        return not isinstance(x, float) or math.isfinite(x)

    def per_repeats(n, rollouts=0):
        return expect(fused_collect=n, fused_actor_grad=10 * n,
                      fused_critic_grad=10 * n, returns=2 * n,
                      fused_rollout=rollouts)

    hold_argv = ["--seeds", "2,42", "--stages", "2", "--grid", "quick",
                 "--sweep-repeats", "20", "--out",
                 os.path.join(out_dir, "hold")]
    rec22 = {}
    for check, want in (("ignition", per_repeats(2 * 600)),
                        ("ignition-jax-init", per_repeats(2 * 600)),
                        ("h42", per_repeats(2 * 600, 2)),
                        ("sweep", per_repeats(2 * 20))):
        reset_counts()
        t0 = time.perf_counter()
        res22 = hld.main(["--check", check] + hold_argv)[check]
        torch.cuda.synchronize()
        wall22, got22 = time.perf_counter() - t0, read_counts()
        if check == "h42":
            summary = [(s["stage"], round(s["share"], 4), s["jax_tar_share"])
                       for s in res22["stages"]]
        elif check == "sweep":
            summary = [(c["risk_factor"], round(c["col_share"], 4),
                        round(c["mean_rew_last"], 1)) for c in res22["cells"]]
        else:
            summary = {s: round(hld.reach_share(r), 4)
                       for s, r in res22["port"].items()}
        print(f"hold --check {check}: {wall22:.2f} s; launches {got22}; "
              f"verdict at this cut {res22['passed']}; {summary}")
        assert finite_tree(res22), (check, res22)
        assert got22 == want, (check, got22, want)
        assert _build.load_libraries.nvcc_runs == nvcc_before
        rec22[check] = {"result": res22, "wall_s": wall22,
                        "launches": got22}
    record["hold_cut"] = rec22
    print(f"(phase took {time.perf_counter() - _PHASE_START[0]:.1f} s)")

    def shape_key(key):
        """(P, T) as "PxT"; other shapes by their label."""
        return f"{key[0]}x{key[1]}" if isinstance(key, tuple) else key

    record["times"] = {name: {shape_key(k): v for k, v in by.items()}
                       for name, by in times.items()}
    record["max_abs_err"] = errors
    record["launches"] = path_launches
    record["card"] = card
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    def entry(name):
        main_ = times[name][MAIN_SHAPE.get(name, (1024, 1000))]
        return {"name": name, "route": "cuda", **KERNELS[name],
                "launches": path_launches[name], "max_abs_err": errors[name],
                "ms": main_["ms"], "plain_ms": main_["plain_ms"],
                "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
                "library_ms": None,
                "bf16_launches": record["bf16"]["launches"].get(name, 0),
                "curriculum_launches": record["curriculum"]["h42"][
                    "launches"].get(name, 0),
                "by_shape": {shape_key(key): {k: v[k] for k in
                                              ("ms", "plain_ms", "bound_ms",
                                               "fp32_bound_ms", "f32_ms")
                                              if k in v}
                             for key, v in times[name].items()}}

    print(json.dumps({"kernels": [entry(name) for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory to keep the training "
                        "artifacts and chip_smoke.json in")
    args = parser.parse_args()
    with contextlib.ExitStack() as stack:
        out = args.out or stack.enter_context(tempfile.TemporaryDirectory())
        main(out)
