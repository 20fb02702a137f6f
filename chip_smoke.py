"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It builds the port's CUDA kernel from the sources in the
checkout, holds it against its plain PyTorch version, checks its random
numbers, trains MAPPO through the port's entry point at the default
configuration (1024 envs, buffer 1000, 50 + 50 epochs) for 2 repeats with
the fused collect, and times the kernel.  Every phase prints as it goes;
any failure exits non-zero.  The last two lines are one JSON object per
kernel and ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, where CUDA is unavailable.  The training artifacts and a JSON
record of the run go to ``--out`` (default: a temporary directory, removed
at exit).
"""

import argparse
import json
import math
import os
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
# blend 83; step counter 2.  Philox's integer work is not counted.
OPS_PER_ENV_STEP = 1830
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 without tensor cores
REPLACES = "marlnav_tpu/ops/fused_collect.py:327"
SOURCE = "marlnav_tpu_torch/ops/csrc/fused_collect.cu"


def phase(title):
    print(f"\n=== {title} ===", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1, warmup=0):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(out_dir):
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    import marlnav_tpu_torch

    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(marlnav_tpu_torch.__file__)) != here:
        sys.exit(f"chip_smoke: marlnav_tpu_torch imported from "
                 f"{marlnav_tpu_torch.__file__}, not from this checkout")
    from marlnav_tpu_torch.__main__ import build_parser
    from marlnav_tpu_torch.algo import make_mappo
    from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                          NormalizerConfig, ScalerConfig,
                                          TriangleInitConfig,
                                          resolve_run_config)
    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops import fused_collect as fc
    from marlnav_tpu_torch.ops._build import find_nvcc
    from marlnav_tpu_torch.ops.step_math import StepMath
    from marlnav_tpu_torch.train import train
    from marlnav_tpu_torch.utils.seeding import make_generator

    dev = torch.device("cuda")
    norm, scal = NormalizerConfig(), ScalerConfig()
    record = {}

    # ------------------------------------------------------------------
    phase("1. device and build")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    build = fc.build_kernel()
    print(f"kernel build: {build['seconds']:.1f} s -> {build['path']}")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    record["build_s"] = build["seconds"]

    def setup(p, t, episode_len=200, noisy=False, tame=False, seed=0):
        """Step math, start rows and the actor operator for one case."""
        ep = EnvParams(num_parallel=p, episode_len=episode_len)
        ic = TriangleInitConfig(num_parallel=p, noisy_ags=noisy)
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
        return StepMath(ep, ic, norm, scal), rows, a_comp, c_comp

    # ------------------------------------------------------------------
    phase("2. kernel against its plain version, same uniforms, P=2048")
    # Both perform the same float32 operations in the same order (the
    # kernel is built with -fmad=false), so they are expected to agree
    # bit for bit.  Asserted: done, rewards and the episode counters
    # exactly; the other fields within the tolerances of the JAX package's
    # own kernel tests (obs 5e-4: acos near dot ~ 1; actions 1e-4;
    # log-probs 1e-3; state 1e-3 on positions ~1e3).
    tol = {"obs": 5e-4, "actions": 1e-4, "log_probs": 1e-3, "rewards": 0.0,
           "state": 1e-3}
    max_err = 0.0
    cases = [("a: T=64, tamed policy", 64, dict(tame=True)),
             ("b: 1 step, untamed", 1, dict()),
             ("c: episode_len=10, noisy_ags, resets", 40,
              dict(episode_len=10, noisy=True, tame=True))]
    for name, t, kw in cases:
        sm, rows, a_comp, c_comp = setup(2048, t, **kw)
        noise = torch.rand((t, sm.n_draws, 2048), device=dev,
                           generator=make_generator(5, dev))
        k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 7, t, noise)
        r = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
        torch.cuda.synchronize()
        errs = {f: (getattr(k, f) - getattr(r, f)).abs().max().item()
                for f in ("obs", "actions", "log_probs", "rewards")}
        errs["state"] = max((x - y).abs().max().item()
                            for x, y in zip(k.rows.fields(), r.rows.fields()))
        print(f"{name}: max abs err " + ", ".join(
            f"{f} {e:.3e}" for f, e in errs.items())
            + f"; done frac {k.done.float().mean().item():.4f}; counters "
            f"kernel {k.stats.tolist()} plain {r.stats.tolist()}")
        for f, e in errs.items():
            assert e <= tol[f], f"{name}: {f} error {e} > {tol[f]}"
        # d: done and the episode counters exactly.
        assert torch.equal(k.done, r.done), f"{name}: done differs"
        assert torch.equal(k.stats, r.stats), f"{name}: counters differ"
        max_err = max(max_err, *errs.values())
    assert k.done.any(), "case c premise: resets fired"
    print("d: done, rewards and counters equal in every case")

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
    phase("4. training: default configuration, 2 repeats, fused collect")
    p, t = 1024, 1000
    args = build_parser().parse_args(
        ["-np", str(p), "-nt", str(2 * p * t), "-se", "0",
         "--output-root", out_dir])  # defaults: -bl 1000 -bs 1000 -ne 50
    cfg = resolve_run_config(args)
    os.makedirs(out_dir, exist_ok=True)
    fc.fused_collect_rows.launches = 0
    t0 = time.perf_counter()
    ts, rows_out, logger = train(cfg, device="cuda", fused_collect=True,
                                 output_root=out_dir)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = fc.fused_collect_rows.launches
    logs = logger.logs
    print(f"train: {train_s:.2f} s for 2 repeats; kernel launches {launches}; "
          f"mean_rew {logs['mean_rews']}; actor losses {len(logs['actor'])}, "
          f"critic losses {len(logs['critic'])}")
    assert launches == 2, f"the main path launched the kernel {launches}x"
    assert len(logs["mean_rews"]) == 2 and len(logs["actor"]) == 100
    for key in ("mean_rews", "actor", "critic"):
        assert all(math.isfinite(v) for v in logs[key]), key
    assert all(x.shape[-1] == p and bool(torch.isfinite(x).all())
               for x in rows_out.fields())

    # Per-phase times of one more repeat through the same functions.
    env = make_env(cfg.env, cfg.init, dev)
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler)
    ts, es = mappo.init(make_generator(0, dev))
    collect = fc.make_fused_collect(cfg.model, cfg.env, cfg.init,
                                    cfg.normalizer, cfg.scaler)
    rows = fc.env_state_to_rows(es)
    out = {}
    times = {"kernel": [], "collect": [], "actor": [], "critic": []}
    for r in range(3):
        times["kernel"].append(cuda_ms(lambda: collect.run_kernel(ts, rows,
                                                                  100 + r)))

        def run_collect():
            out["c"] = collect(ts, rows, 100 + r)
        times["collect"].append(cuda_ms(run_collect))
        buf = out["c"][1]
        times["actor"].append(cuda_ms(lambda: mappo.train_actor(ts, buf)))
        times["critic"].append(cuda_ms(lambda: mappo.train_critic(ts, buf)))
    ph = {k: statistics.median(v) for k, v in times.items()}
    ph["returns_tail"] = ph["collect"] - ph["kernel"]
    repeat_ms = ph["collect"] + ph["actor"] + ph["critic"]
    print(f"per repeat (median of 3, CUDA events): kernel {ph['kernel']:.3f} "
          f"ms, critic values + returns tail {ph['returns_tail']:.3f} ms, "
          f"actor phase {ph['actor']:.3f} ms, critic phase "
          f"{ph['critic']:.3f} ms; repeat {repeat_ms:.3f} ms = "
          f"{p * t / repeat_ms * 1e3:,.0f} env-steps/s")
    record["phases_ms"] = ph
    record["env_steps_per_s"] = p * t / repeat_ms * 1e3

    # ------------------------------------------------------------------
    phase("5. times, and the kernel against its plain version at these shapes")
    shapes = {}
    for p, t in ((1024, 1000), (16384, 200)):
        sm, rows, a_comp, c_comp = setup(p, t)
        k_ms = cuda_ms(lambda: fc.fused_collect_rows(sm, rows, a_comp, c_comp,
                                                     3, t), reps=7, warmup=2)
        uniforms = torch.rand((t, sm.n_draws, p), device=dev,
                              generator=make_generator(4, dev))
        plain_ms = cuda_ms(lambda: out.update(
            r=fc.collect_rows_reference(sm, rows, a_comp, c_comp, uniforms)))
        # The untamed initial actor over the whole rollout, resets included,
        # on the same uniforms: exact agreement is expected, as in phase 2.
        k = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, t, uniforms)
        torch.cuda.synchronize()
        errs = {f: (getattr(k, f) - getattr(out["r"], f)).abs().max().item()
                for f in ("obs", "actions", "log_probs", "rewards")}
        print(f"P={p} T={t} untamed, same uniforms: max abs err " + ", ".join(
            f"{f} {e:.3e}" for f, e in errs.items())
            + f"; done frac {k.done.float().mean().item():.4f}; counters "
            f"kernel {k.stats.tolist()} plain {out['r'].stats.tolist()}")
        for f, e in errs.items():
            assert e <= tol[f], f"P={p} T={t}: {f} error {e} > {tol[f]}"
        assert torch.equal(k.done, out["r"].done)
        assert torch.equal(k.stats, out["r"].stats)
        max_err = max(max_err, *errs.values())
        n_rows = sum(x.shape[0] for x in rows.fields())
        a, f = sm.a, sm.obs_size
        nbytes = (t * p * (4 * (a * f + 2 * a + a + 1) + 1)  # buffer out
                  + 2 * n_rows * p * 4 + 4 * (4 * f + 4) + 3 * 4)
        ops = OPS_PER_ENV_STEP * t * p
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        shapes[(p, t)] = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by="bytes" if bytes_ms >= ops_ms
                              else "operations")
        print(f"fused_collect P={p} T={t}: kernel {k_ms:.3f} ms (median of "
              f"7), plain version {plain_ms:.1f} ms (1 run), bound "
              f"{bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB -> "
              f"{bytes_ms * 1e3:.1f} us; {ops / 1e9:.2f} GFLOP -> "
              f"{ops_ms * 1e3:.1f} us); {p * t / k_ms * 1e3:,.0f} env-steps/s")
    record["times"] = {f"{p}x{t}": v for (p, t), v in shapes.items()}
    record["max_abs_err"] = max_err
    record["card"] = card
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    main_shape = shapes[(1024, 1000)]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_collect", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "launched": launches > 0,
        "checked": True, "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "ms_16384x200": shapes[(16384, 200)]["ms"],
        "plain_ms_16384x200": shapes[(16384, 200)]["plain_ms"],
        "bound_ms_16384x200": shapes[(16384, 200)]["bound_ms"]}]}))
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
