"""MARL-nav at 17 obstacles on the card (the benchmark's
``obstacles17.train``): obs 40 and critic In 120, past the templated
instances, so the collect takes ``fused_collect_rt_kernel`` and the critic
the run-time-width route.

The run-time collect equals the benchmark's plain reference (its step op
for op, its uniforms from Philox) bit for bit; graphed training repeats
count the route's launches in ``rt_launches`` through ``CountedGraph``
replays: 50 critic gradients and one collect a repeat, and none at 3
obstacles; at In 120 / H 50 every gradient takes the route in one pass
(``rt_one_pass_launches``)."""

import json
import os

import pytest
import torch

from marlnav_tpu_torch.__main__ import build_parser
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops.graphs import kernel_wrappers
from marlnav_tpu_torch.train import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "marlnav_obstacles17.json")) as fh:
        return json.load(fh)


@pytest.mark.cuda
def test_the_rt_collect_equals_the_reference_on_the_card(cuda):
    """1,000 envs x 300 steps at 17 obstacles from the benchmark's initial
    rows, counters late in an episode (resets fire): every record, count
    and final row of ``fused_collect_rt_kernel`` equals the reference's,
    which draws the kernel's Philox uniforms."""
    from benchmark.harness import inputs
    from benchmark.reference import compare, philox
    from benchmark.reference.env_step import ROW_FIELDS, EnvStep
    from benchmark.reference.mappo import collect
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops.step_math import StepMath

    config, envs, steps, seed = _config(), 1000, 300, 2 ** 31 + 5
    gen = torch.Generator().manual_seed(11)
    weights = inputs.initial_weights(gen, inputs.network_shapes(config),
                                     "cpu")
    rows = inputs.initial_rows(gen, config, envs, "cpu")
    rows["misc"][0] = torch.arange(envs, dtype=torch.float32) % 40 + 160
    weights = {k: v.to(cuda) for k, v in weights["actor"].items()}
    rows = {k: v.to(cuda) for k, v in rows.items()}
    ep, icfg, norm, scal, _ = inputs.port_configs(config, envs)
    sm = StepMath(ep, icfg, norm, scal)
    lib, _ = fc._library()
    assert sm.o == 17 > lib.marlnav_collect_max_obstacles()
    actor = Actor(40, 50).to(cuda)
    inputs.load_weights(actor, weights)
    step = EnvStep(config["env"], config["init"], config["normalizer"],
                   config["scaler"])
    u = philox.uniforms(seed, envs, steps, step.n_draws, cuda)
    before = fc.fused_collect_rows.rt_launches
    out = fc.fused_collect_rows(sm, fc.RowState(*(rows[k] for k in
                                                  ROW_FIELDS)),
                                *fc._affine_compose(actor), seed, steps)
    assert fc.fused_collect_rows.rt_launches == before + 1
    final, buf, counts = collect(step, rows, weights, u)
    torch.cuda.synchronize()
    assert bool(out.done.any())  # premise: resets fired
    for k in ("obs", "actions", "log_probs", "rewards", "done"):
        assert torch.equal(buf[k], getattr(out, k)), k
    assert counts.tolist() == out.stats.tolist()
    assert compare.rows_gap(final, dict(zip(ROW_FIELDS,
                                            out.rows.fields()))) == 0.0


def _run(obstacles, repeats, tmp_path):
    cfg = resolve_run_config(build_parser().parse_args(
        ["-np", "64", "-bl", "20", "-bs", "20", "-ne", "50", "-se", "5",
         "-no", str(obstacles), "-nt", str(repeats * 64 * 20),
         "--fused-updates"]))
    return train(cfg, device="cuda", fused_collect=True, verbose=False,
                 output_root=str(tmp_path / str(obstacles)), jit_repeats=2)


@pytest.mark.cuda
@pytest.mark.parametrize("obstacles", [17, 3])
def test_graphed_repeats_count_the_route_s_launches(cuda, tmp_path,
                                                    obstacles):
    """Five repeats in blocks of 2 (an eager block, a graphed block
    replayed, an eager tail), 50 critic epochs each: at 17 obstacles
    ``critic_grad_sums.rt_launches`` counts 50 and
    ``fused_collect_rows.rt_launches`` 1 a repeat, replays included, as
    ``launches`` does, and every critic gradient takes the route in one
    pass (``rt_one_pass_launches`` 50 a repeat); the un-collapsed actor
    does not run (the affine actor takes F 40).  At 3 obstacles none of
    them counts."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        for counter in ("rt_launches", "rt_one_pass_launches"):
            if hasattr(fn, counter):
                setattr(fn, counter, 0)
    _run(obstacles, 5, tmp_path)
    torch.cuda.synchronize()
    assert fc.fused_collect_rows.launches == 5
    assert fu.critic_grad_sums.launches == 5 * 50
    rt = obstacles == 17
    assert fc.fused_collect_rows.rt_launches == (5 if rt else 0)
    assert fu.critic_grad_sums.rt_launches == (5 * 50 if rt else 0)
    assert fu.critic_grad_sums.rt_one_pass_launches == \
        fu.critic_grad_sums.rt_launches
    assert fu.actor_grad_uncollapsed_sums.launches == 0
    assert fu.actor_grad_uncollapsed_sums.rt_launches == 0
    assert fu.actor_grad_uncollapsed_sums.rt_one_pass_launches == 0
