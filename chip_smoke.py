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
bit for bit and times it, trains 2 short repeats with
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
--save-animation or its error without matplotlib); and times every
kernel.  Each path's launch
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
# Kernels whose products fit the tensor cores (TPU rows 3, 4, 6 and 7):
# their bound takes the TF32 rate, with the 67 TFLOP/s share beside it.
TENSOR_CORE_WORK = {"fused_critic_grad", "fused_actor_grad_uncollapsed"}
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
# KS, NT), as the CUDA 12.9 toolkit's ptxas reports them for sm_90a: the
# default un-collapsed actor's (held to 128 registers for two blocks an
# SM) and one critic instance's.  Every other instance spills nothing.
SPILL_STORES_TODAY = {("actor", 2, 7): 12, ("critic", 9, 16): 4}


def phase(title):
    print(f"\n=== {title} ===", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def hmma_counts(sass, bf16=False):
    """{(head, KS, NT): HMMA instructions} of each instance of
    tc_grad_kernel<CriticHead<NT> or ActorHead<NT>, KS> (with ``bf16``,
    CriticHeadBf16 or ActorHeadBf16) in ``cuobjdump -sass`` output."""
    counts, key = {}, None
    head = "HeadBf16" if bf16 else "Head"
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"tc_grad_kernelI\w*?(Critic|Actor)" + head +
                          r"ILi(\d+)EEELi(\d+)E", line)
            key = ((m.group(1).lower(), int(m.group(3)), int(m.group(2)))
                   if m else None)
            if key:
                counts[key] = 0
        elif key and "HMMA" in line:
            counts[key] += 1
    return counts


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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ops": sum(e.count for e in on_device),
            "launch_calls": launches, "ours": ours}


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
    from marlnav_tpu_torch.algo.mappo import (minibatch_advantages,
                                              minibatch_slices)
    from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                          NormalizerConfig, ScalerConfig,
                                          TriangleInitConfig,
                                          resolve_run_config)
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.models import Actor, Critic
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops import fused_rollout as fr
    from marlnav_tpu_torch.ops import fused_update as fu
    from marlnav_tpu_torch.ops import update_math as um
    from marlnav_tpu_torch.ops import returns as tr
    from marlnav_tpu_torch.ops._build import (BUILD_DIR, find_nvcc,
                                              load_libraries)
    from marlnav_tpu_torch.ops.graphs import CountedGraph, kernel_wrappers
    from marlnav_tpu_torch.ops.step_math import StepMath
    from marlnav_tpu_torch.train import train
    from marlnav_tpu_torch.utils.seeding import make_generator

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
    # past 8 obstacles, the gradient route past the tensor-core instances
    # (forward and backward, critic and un-collapsed actor, float32 and
    # bf16).  None may spill.
    record["runtime_ptxas"] = {}
    for lib_name, mangled in (
            ("fused_collect", "fused_collect_rt_kernel"),
            ("fused_rollout", "fused_rollout_rt_kernelILb0E"),
            ("fused_rollout", "fused_rollout_rt_kernelILb1E"),
            *(("fused_update", f"rt_{part}_kernelILb{actor}ELb{bf16}E")
              for part in ("forward", "backward") for actor in (0, 1)
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
        spilled = {}
        for (head, ks, nt), count in sorted(hmma.items()):
            line = instance_line(builds["fused_update"][1]["log"],
                                 f"{head.capitalize()}HeadILi{nt}EEELi{ks}E")
            print(f"tc_grad_kernel<{head.capitalize()}Head<NT={nt}>, KS={ks}>"
                  f": {count} HMMA in its SASS (forward: {3 * ks * nt}); "
                  + line)
            stores = re.findall(r"(\d+) bytes spill stores", line)
            assert stores, line
            spilled[(head, ks, nt)] = int(stores[0])
        assert {h for h, _, _ in hmma} == {"critic", "actor"}, hmma
        assert all(c > 0 for c in hmma.values()), hmma
        # No instance may spill more than it does today: none but these two,
        # the default un-collapsed actor's among them (PERF.md, open
        # questions; ROADMAP.md Queue 3).
        worse = {k: v for k, v in spilled.items()
                 if v > SPILL_STORES_TODAY.get(k, 0)}
        assert not worse, f"tc_grad_kernel spill stores grew: {worse}"
        record["tc_hmma"] = {f"{k}": c for k, c in hmma.items()}
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
    else:
        print("cuobjdump not found: HMMA count not measured")

    def setup(p, t, episode_len=200, noisy=False, tame=False, seed=0, o=3):
        """Step math, start rows and the actor operator for one case, with
        o obstacles."""
        ep = EnvParams(num_parallel=p, episode_len=episode_len,
                       num_obstacles=o)
        ic = TriangleInitConfig(num_parallel=p, noisy_ags=noisy,
                                num_obstacles=o)
        env = make_env(ep, ic, dev)
        rows = fc.env_state_to_rows(env.init(make_generator(seed, dev)))
        actor = Actor(ep.obs_size, 50,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
        if tame:  # tests/test_fused_collect.py tame_policy
            with torch.no_grad():
                actor.fc_mu.weight.mul_(1e-3)
                actor.fc_mu.bias.mul_(1e-3)
                actor.fc_var.bias.sub_(20.0)
        a_comp, c_comp = fc._affine_compose(actor)
        return (StepMath(ep, ic, NormalizerConfig(num_obstacles=o), scal),
                rows, a_comp, c_comp)

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

    # Past 8 obstacles the run-time instance (fused_collect_rt_kernel): at
    # O 9, 17 and 32, every field equal to the plain version through
    # resets (episode_len 10, noisy_ags, ragged P 1000, T 32, both timed
    # there), and the kernel timed at the main path's (1024, 1000).
    for o in (9, 17, 32):
        sm, rows, a_comp, c_comp = setup(1000, 32, episode_len=10, noisy=True,
                                         o=o)
        uniforms = torch.rand((32, sm.n_draws, 1000), device=dev,
                              generator=make_generator(8, dev))
        k_ms = cuda_ms(lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 32, uniforms), reps=7, warmup=2)
        plain_ms = cuda_ms(lambda: out.update(
            r=fc.collect_rows_reference(sm, rows, a_comp, c_comp, uniforms)))
        k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, 32, uniforms)
        torch.cuda.synchronize()
        errs = collect_errors(k, out["r"])
        print(f"O={o} P=1000 T=32 resets, same uniforms: max abs err "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
              + f"; done frac {k.done.float().mean().item():.4f}")
        assert all(e == 0.0 for e in errs.values()), (o, errs)
        assert torch.equal(k.done, out["r"].done) and k.done.any()
        assert torch.equal(k.stats, out["r"].stats)
        bound_ms, by, _, _ = collect_bound(sm, rows, 1000, 32)
        shapes[f"O={o} 1000x32"] = dict(ms=k_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=by)
        sm, rows, a_comp, c_comp = setup(1024, 1000, o=o)
        main_ms = cuda_ms(lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, 3, 1000), reps=7, warmup=2)
        bound_ms, by, nbytes, ops = collect_bound(sm, rows, 1024, 1000)
        shapes[f"O={o} 1024x1000"] = dict(ms=main_ms, bound_ms=bound_ms,
                                          bound_by=by)
        print(f"fused_collect O={o}: P=1000 T=32 kernel {k_ms:.4f} ms, "
              f"plain version {plain_ms:.1f} ms (1 run); P=1024 T=1000 "
              f"kernel {main_ms:.4f} ms (medians of 7), "
              f"{main_ms * 1e3 / 1000:.3f} us a step, bound "
              f"{bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB; "
              f"{ops / 1e9:.2f} GFLOP), {bound_ms / main_ms:.1%} of it; "
              f"{1024 * 1000 / main_ms * 1e3:,.0f} env-steps/s")
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
    # magnitude (+1e-7), and two launches equal bit for bit.
    fns = {"fused_actor_grad": (fu.actor_grad_sums,
                                um.actor_grad_sums_reference),
           "fused_critic_grad": (fu.critic_grad_sums,
                                 um.critic_grad_sums_reference),
           "fused_actor_grad_uncollapsed": (
               fu.actor_grad_uncollapsed_sums,
               um.actor_grad_sums_uncollapsed_reference)}
    # The argument whose first dimension is the row count.
    rows_arg = {"fused_actor_grad": 4, "fused_critic_grad": 4,
                "fused_actor_grad_uncollapsed": 6}

    def actor_inputs(actor, mb, mcfg):
        n = mb.log_probs.numel()
        a_comp, c_comp = fc._affine_compose(actor)
        return (a_comp, c_comp, mb.obs.reshape(n, -1),
                mb.actions.reshape(n, -1), mb.log_probs.reshape(n),
                minibatch_advantages(mb, mcfg), mcfg.epsilon, mcfg.ent_const)

    def critic_inputs(c, mb, mcfg):
        n = mb.returns.numel()
        return (c.fc1.weight.detach(), c.fc1.bias.detach(),
                c.fc2.weight.detach(), c.fc2.bias.detach(),
                mb.obs.reshape(n, -1), mb.values.reshape(n),
                mb.returns.reshape(n), mcfg.epsilon)

    def uncollapsed_inputs(actor, mb, mcfg):
        n = mb.log_probs.numel()
        # parameters(): fc1, fc_mu, fc_var, each weight then bias.
        return (*(p_.detach() for p_ in actor.parameters()),
                mb.obs.reshape(n, -1), mb.actions.reshape(n, -1),
                mb.log_probs.reshape(n), minibatch_advantages(mb, mcfg),
                mcfg.epsilon, mcfg.ent_const)

    actor_fns = {"fused_actor_grad": actor_inputs,
                 "fused_actor_grad_uncollapsed": uncollapsed_inputs}
    # The outputs of each kernel, in order.
    outputs = {"fused_actor_grad": ("loss", "dz", "dzs"),
               "fused_critic_grad": ("loss", "dW1", "db1", "dW2", "db2"),
               "fused_actor_grad_uncollapsed": (
                   "loss", "dW1", "db1", "dWmu", "dbmu", "dWvar", "dbvar")}
    record["output_errors"] = {}

    def check(name, label, args):
        kernel, plain = fns[name]
        n = args[rows_arg[name]].shape[0]
        k1, k2 = kernel(*args), kernel(*args)
        p32 = plain(*args)
        p64 = plain(*(x.double() if torch.is_tensor(x) else x for x in args))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k1, k2)), \
            f"{name} {label}: two launches differ"
        err_k = err_p = 0.0
        per_output = {}
        for out_name, k, q, w in zip(outputs[name], k1, p32, p64):
            w = w / n
            ek = (k.double() / n - w).abs().max().item()
            ep = (q.double() / n - w).abs().max().item()
            tol = 1e-4 * w.abs().max().item() + 1e-7
            err_k, err_p = max(err_k, ek), max(err_p, ep)
            per_output[out_name] = (ek, ep, tol)
        print(f"{name} {label}: {n:,} rows; max abs err against float64: "
              f"kernel {err_k:.3e}, plain float32 {err_p:.3e}; two launches "
              f"bitwise equal")
        if name in TENSOR_CORE_WORK:
            # Which output carries the tensor-core kernels' error.
            print("  per output, kernel / plain float32: " + ", ".join(
                f"{o} {ek:.2e} / {ep:.2e} ({ek / ep if ep else math.inf:.1f}x)"
                for o, (ek, ep, _) in per_output.items()))
            record["output_errors"][f"{name} {label}"] = per_output
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

    def time_kernels(key, label, inputs, mcfg, widths=None):
        """Each kernel and its plain version on ``inputs``, against the
        bound, kept in ``times`` under ``key``."""
        for name, args in inputs.items():
            kernel, plain = fns[name]
            n = args[rows_arg[name]].shape[0]
            nbytes, ops = update_work(name, n, mcfg, widths)
            k_ms = cuda_ms(lambda: kernel(*args), reps=7, warmup=2)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            fp32_ms = ops / FP32_OPS_PER_S * 1e3
            ops_ms = (ops / TF32_OPS_PER_S * 1e3 if name in TENSOR_CORE_WORK
                      else fp32_ms)
            bound_ms = max(bytes_ms, ops_ms)
            times[name][key] = dict(
                ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            rate = "TF32" if name in TENSOR_CORE_WORK else "float32"
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
        scfg = resolve_run_config(build_parser().parse_args(
            ["-np", str(p), "-bl", str(t), "-bs", str(t), "-nt", str(p * t),
             "-se", "0"]))
        mcfg = scfg.model
        mappo = make_mappo(mcfg, make_env(scfg.env, scfg.init, dev),
                           scfg.normalizer, scfg.scaler)
        ts, es = mappo.init(make_generator(1, dev))
        _, buf, _ = fc.make_fused_collect(
            mcfg, scfg.env, scfg.init, scfg.normalizer, scfg.scaler)(
                ts, fc.env_state_to_rows(es), 7)
        mb = minibatch_slices(buf, mcfg)[0]
        g = torch.Generator().manual_seed(2)
        actor = Actor(mcfg.obs_size, mcfg.hidden_size, generator=g).to(dev)
        critic = Critic(mcfg.obs_size, mcfg.num_agents, mcfg.hidden_size,
                        generator=g).to(dev)

        def all_inputs(smb, scfg_):
            out_ = {name: fn(actor, smb, scfg_)
                    for name, fn in actor_fns.items()}
            out_["fused_critic_grad"] = critic_inputs(critic, smb, scfg_)
            return out_

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
            for name, fn in actor_fns.items():
                check(name, "collecting actor (ratios ~1, tied)",
                      fn(ts.actor, mb, mcfg))
            check("fused_critic_grad", "collecting critic (all rows tied)",
                  critic_inputs(ts.critic, mb, mcfg))
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
    # whole gradient jumps.  Returns apart from both.
    lib = fu._library()
    max_h = lib.marlnav_max_hidden()
    n = 200_003

    def margins(gen):
        """n offsets of -0.4, -0.05, 0.05 or 0.4."""
        return torch.tensor([-0.4, -0.05, 0.05, 0.4], device=dev)[
            torch.randint(0, 4, (n,), device=dev, generator=gen)]

    wide = {"fused_critic_grad": [
                (2, EnvParams(num_agents=2).obs_size, 32), (3, 22, 50),
                (3, 12, 128), (4, 24, 128), (1, 103, 128), (3, 12, 256),
                (3, 34, 256), (1, lib.marlnav_critic_max_in(), max_h),
                (3, 40, 50), (1, 210, 64), (3, 12, 512), (1, 103, 257)],
            "fused_actor_grad_uncollapsed": [
                (1, 22, 50), (1, 22, 128), (1, 32, 128), (1, 39, 128),
                (1, 12, 256), (1, 34, 256),
                (1, lib.marlnav_uncollapsed_max_obs(), max_h),
                (1, 40, 50), (1, 70, 128), (1, 12, 512)],
            "fused_actor_grad": [(1, 22, 50), (1, 32, 50), (1, 34, 50),
                                 (1, 13, 50), (1, 255, 50), (1, 256, 50),
                                 (1, 300, 50)]}

    def wide_case(name, agents, f, h):
        """(label, args) of ``name`` on n random rows at these widths."""
        gen = make_generator(20 + f + h, dev)
        net_gen = torch.Generator().manual_seed(h)
        x = torch.randn((n, agents * f), device=dev, generator=gen)
        if name == "fused_critic_grad":
            critic = Critic(f, agents, h, generator=net_gen).to(dev)
            # Hidden biases of +-2 against pre-activations of spread at
            # most 1 (x ~ N(0, 1), orthogonal W1): no unit sits at the
            # ReLU's kink, where the kernel's and float64's roundings
            # may take different sides and a row's whole term of dW1
            # and db1 jumps.
            with torch.no_grad():
                critic.fc1.bias.copy_(2.0 * torch.sign(torch.randn(
                    h, device=dev, generator=gen)))
                v = critic(x)[:, 0]
            label = f"In {agents * f}, H {h}"
            args = (critic.fc1.weight.detach(), critic.fc1.bias.detach(),
                    critic.fc2.weight.detach(), critic.fc2.bias.detach(),
                    x, v + margins(gen),
                    torch.randn(n, device=dev, generator=gen), 0.2)
        else:
            actor = Actor(f, h, generator=net_gen).to(dev)
            label = f"F {f}" + (f", H {h}" if name != "fused_actor_grad"
                                else "")
            act = torch.rand((n, 2), device=dev, generator=gen) * 2 - 1
            with torch.no_grad():
                hid = actor.fc1(x)
                var = torch.nn.functional.softplus(actor.fc_var(hid))
                lp = -0.5 * (2.0 * math.log(2.0 * math.pi)
                             + torch.log(var).sum(1)
                             + ((act - torch.tanh(actor.fc_mu(hid))) ** 2
                                / var).sum(1))
            rows = (x, act, lp + margins(gen),
                    torch.randn(n, device=dev, generator=gen), 0.2, 0.001)
            weights = (fc._affine_compose(actor) if name ==
                       "fused_actor_grad" else
                       tuple(p_.detach() for p_ in actor.parameters()))
            args = (*weights, *rows)
        return label, args

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
            if runtime_route(name, agents, f, h):
                label += " (run-time route)"
            check(name, label, args)
            time_kernels(label, label, {name: args}, None,
                         (f, h, agents * f))

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
    # Past 8 obstacles the run-time instance (fused_rollout_rt_kernel): at
    # O 9, 17 and 32, both modes equal to the plain version through resets
    # at a ragged P 1000 (T 32, both timed there), the sampled one equal to
    # the collect kernel from the same Philox seed; the kernel timed at the
    # bench's (16384, 500).
    for o in (9, 17, 32):
        sm, rows, a_comp, c_comp = setup(1000, 32, episode_len=10, noisy=True,
                                         o=o)
        uniforms = torch.rand((32, sm.n_draws, 1000), device=dev,
                              generator=make_generator(9, dev))
        small = {}
        for det in (False, True):
            k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, 32, det,
                                      uniforms)
            plain = {}
            plain_ms = cuda_ms(lambda: plain.update(
                r=fr.rollout_rows_reference(sm, rows, a_comp, c_comp,
                                            uniforms, det)))
            torch.cuda.synchronize()
            err = same_rollout(k, plain["r"])
            assert err == 0.0, f"rollout O={o} det={det}: kernel != plain"
            small[det] = plain_ms
        k_ms = cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 11, 32, False, uniforms), reps=7,
            warmup=2)
        col = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 11, 32)
        k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 11, 32, False)
        torch.cuda.synchronize()
        assert same_rollout(k, (col.rows, col.rewards)) == 0.0, o
        assert col.done.any()
        bound_ms, bound_by, _, _ = rollout_bound(sm, rows, 1000, 32)
        times["fused_rollout"][f"O={o} 1000x32"] = dict(
            ms=k_ms, plain_ms=small[False], bound_ms=bound_ms,
            bound_by=bound_by)
        sm, rows, a_comp, c_comp = setup(16384, 500, o=o)
        ms = {det: cuda_ms(lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 3, 500, det), reps=7, warmup=2)
            for det in (False, True)}
        bound_ms, bound_by, _, _ = rollout_bound(sm, rows, 16384, 500)
        times["fused_rollout"][f"O={o} 16384x500"] = dict(
            ms=ms[False], bound_ms=bound_ms, bound_by=bound_by,
            policy_mean_ms=ms[True])
        print(f"fused_rollout O={o}: kernel == plain (both modes) and == "
              f"collect at P=1000 T=32 (kernel {k_ms:.4f} ms, plain "
              f"{small[False]:.1f} / {small[True]:.1f} ms); P=16384 T=500: "
              f"{ms[False]:.4f} ms sampled, {ms[True]:.4f} ms policy mean "
              f"(medians of 7), bound {bound_ms * 1e3:.1f} us ({bound_by}), "
              f"{bound_ms / ms[False]:.1%} of it; "
              f"{16384 * 500 / ms[False] * 1e3:,.0f} env-steps/s")

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
    # width route; -hs 512 the latter for both.
    record["wide_training"] = {}
    epochs, wp, wt = 5, 256, 100
    for extra, fused_collect in (
            (["-no", "8"], True), (["-hs", "128"], True),
            (["-hs", "256"], True), (["-no", "14"], False),
            (["-no", "17"], True), (["-hs", "512"], True)):
        for layout, bs in ((None, wt), ("packed", wt // 2)):
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
    bf16_modes = {"fused_actor_grad": ("tiled", "staged"),
                  "fused_critic_grad": (True,),
                  "fused_actor_grad_uncollapsed": (True,)}
    record["bf16"] = {"errors": {}}

    def check16(name, mode, label, args):
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
        record["bf16"]["errors"][tag] = per

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
    out = parser.parse_args().out
    if out:
        main(out)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
