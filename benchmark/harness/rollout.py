"""The ``rollout`` traffic: calls of the port's fused rollout
(``make_fused_rollout``), as ``bench.py`` and the curriculum's evaluation
make them.

Each call steps every env T steps with the actor the seed drew, on a fresh
kernel seed, from the rows the previous call left; its rewards are reduced
to a mean on the device.  At most two calls are in flight: the host waits
for call i - 1 once call i is enqueued.  The window closes with a
synchronise.  The check recomputes ``sampled_calls`` calls, drawn from the
seed among the calls the window is sure to make, from the rows each
started from (kept by reference: every call returns new tensors).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import inputs
from benchmark.harness.train import PORT_ROWS


class Traffic:
    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.traffic, self.config = cell.traffic, cell.config
        self.envs, self.steps = self.traffic["envs"], self.traffic["steps"]
        self.deterministic = self.traffic["policy_mean"]
        self.base_seed = (seed * 1_000_003) % (1 << 30)

    def setup(self):
        from marlnav_tpu_torch.models import Actor
        from marlnav_tpu_torch.ops.fused_collect import RowState
        from marlnav_tpu_torch.ops.fused_rollout import make_fused_rollout

        dev = self.dev
        if dev.type == "cuda":
            from marlnav_tpu_torch.ops._build import load_libraries

            load_libraries(["fused_rollout"])
        ep, icfg, norm, scal, mcfg = inputs.port_configs(self.config,
                                                         self.envs)
        self.ep = ep
        self.roll = make_fused_rollout(ep, icfg, norm, scal, self.steps,
                                       self.deterministic, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        weights = inputs.initial_weights(
            gen, {"actor": inputs.network_shapes(self.config)["actor"]}, dev)
        rows = inputs.initial_rows(gen, self.config, self.envs, dev)
        self.actor_weights = weights["actor"]
        actor = Actor(mcfg.obs_size, mcfg.hidden_size, mcfg.action_size)
        actor = actor.to(dev)
        inputs.load_weights(actor, self.actor_weights)
        self.actor = actor
        self.rows = RowState(*(rows[k] for k in PORT_ROWS))
        self.calls = 0
        # Warm-up: calls whose outputs are held as the sample's are, so
        # that the allocator holds the memory the window keeps; the last
        # one timed for the sample's range.
        held = [self.call() for _ in range(self.cell.cell["sampled_calls"]
                                           + 1)]
        self.sync()
        del held
        t0 = time.perf_counter()
        self.call()
        self.sync()
        self.call_s = time.perf_counter() - t0
        self.kept = {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call(self, means=None, index=None):
        seed = self.base_seed + self.calls
        rows_in = self.rows
        self.rows, rewards = self.roll(rows_in, self.actor, seed)
        if means is not None:
            means[index] = torch.mean(rewards)
        self.calls += 1
        return seed, rows_in, rewards

    def window(self, seconds: float):
        """Calls until ``seconds`` have passed (and at least the calls the
        sample is drawn from); returns the window's numbers."""
        sampled = self.cell.cell["sampled_calls"]
        sure = max(sampled, int(0.5 * seconds / self.call_s))
        picks = set(random.Random(self.seed).sample(range(sure), sampled))
        means = torch.zeros(sure * 8 + 64, device=self.dev)
        done = [None, None]
        n = 0
        t0 = time.perf_counter()
        while True:
            if n >= means.numel():
                means = torch.cat([means, torch.zeros_like(means)])
            seed, rows_in, rewards = self.call(means, n)
            if n in picks:
                self.kept[n] = (seed, rows_in, self.rows, rewards)
            if self.dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                if done[(n - 1) % 2] is not None:
                    done[(n - 1) % 2].synchronize()
                done[n % 2] = ev
            n += 1
            if n >= sure and time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        dt = time.perf_counter() - t0
        bad = int((~torch.isfinite(means[:n])).sum())
        return {"rollout_env_steps_per_s": n * self.envs * self.steps / dt,
                "attempted": n, "failed": bad}

    def traced(self, calls: int, sync):
        """``calls`` calls under the profiler, the sample drawn among
        them: ``(profiler output, host spans, calls)``."""
        from benchmark.harness.trace import traced

        sampled = self.cell.cell["sampled_calls"]
        picks = set(random.Random(self.seed).sample(range(calls), sampled))
        with traced(sync) as out:
            for n in range(calls):
                with torch.profiler.record_function("bench.call"):
                    seed, rows_in, rewards = self.call()
                if n in picks:
                    self.kept[n] = (seed, rows_in, self.rows, rewards)
        return out, [], calls

    def shapes(self) -> dict:
        return {"envs": self.envs, "steps": self.steps,
                "obstacles": self.ep.num_obstacles,
                "agents": self.config["model"]["num_agents"],
                "obs": self.config["model"]["obs_size"],
                "hidden": self.config["model"]["hidden_size"],
                "policy_mean": self.deterministic}

    def release(self):
        keep = {"kept": self.kept, "actor": self.actor_weights}
        self.roll = self.actor = self.rows = None
        return keep

    def n_draws(self) -> int:
        o = self.config["env"]["num_obstacles"]
        return 6 + 2 * o + (9 if self.config["init"]["noisy_ags"] else 0)


def check(traffic: Traffic, keep: dict, uniforms_fn,
          rounding=None) -> dict:
    """The compared numbers of the sampled calls; ``rounding`` runs the
    reference in a lower precision (the control)."""
    from benchmark.reference import compare
    from benchmark.reference.env_step import EnvStep, roll

    cfg = traffic.config
    step = EnvStep(cfg["env"], cfg["init"], cfg["normalizer"], cfg["scaler"])
    readings = []
    for n in sorted(keep["kept"]):
        seed, rows_in, rows_out, rewards = keep["kept"][n]
        start = dict(zip(PORT_ROWS, rows_in.fields()))
        uniforms = uniforms_fn(seed, traffic.envs, traffic.steps,
                               traffic.n_draws(), rewards.device)
        ref_rewards = torch.empty_like(rewards)

        def on_step(t, rec):
            ref_rewards[t] = rec["reward"]

        ref_rows = roll(step, start, keep["actor"], uniforms,
                        traffic.deterministic, on_step, rounding)
        del uniforms
        readings.append(compare.rollout_numbers(
            dict(zip(PORT_ROWS, rows_out.fields())), rewards, ref_rows,
            ref_rewards))
    return compare.worst(readings)
