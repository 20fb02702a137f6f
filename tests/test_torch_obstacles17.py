"""The benchmark's ``obstacles17.train`` cell on the CPU: MARL-nav's
defaults at 17 obstacles (obs 2 + 4 + 2 x 17 = 40, critic In 3 x 40 =
120), where the card takes the collect's run-time instance and the
critic's run-time-width route.

A toy-sized run of the cell through the harness is ``correct``; the
port's plain collect at 17 obstacles equals the reference's step bit for
bit; the plain critic gradient at In 120 / H 50 agrees with the
reference's float64 gradient; the cell's roofline reader of the route
counts its kernels and nothing else.  The kernels themselves run on the
card (``tests_cuda/test_cuda_obstacles17.py``)."""

import json
import os

import pytest
import torch

from benchmark.harness import inputs, spec
from benchmark.harness.runner import Context
from benchmark.harness.trace import DeviceWork
from benchmark.reference import mappo as ref_mappo
from benchmark.reference.env_step import ROW_FIELDS, EnvStep

CELL = "obstacles17.train"
CONFIG = "marlnav_obstacles17"
OBSTACLES, OBS, HIDDEN, AGENTS = 17, 40, 50, 3


def _config(name=CONFIG):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def test_the_configuration_is_the_default_at_17_obstacles():
    """Only the obstacle count and the observation width differ from
    ``marlnav_default``; nothing is cut."""
    config, default = _config(), _config("marlnav_default")
    assert config["reduced"] == [] and set(config) == set(default)
    changed = {(group, k) for group in ("env", "init", "normalizer",
                                        "scaler", "model")
               for k in default[group]
               if config[group][k] != default[group][k]}
    assert changed == {("env", "num_obstacles"), ("init", "num_obstacles"),
                       ("normalizer", "num_obstacles"),
                       ("model", "obs_size")}
    assert config["env"]["num_obstacles"] == OBSTACLES
    assert config["model"]["obs_size"] == 2 + 4 + 2 * OBSTACLES == OBS
    cell = spec.find_cell(CELL)
    assert (cell.chips, cell.config_name, cell.traffic_name) == (
        1, CONFIG, "train_graphed_blocks")


@pytest.fixture
def cpu_uniforms():
    """The uniforms the port's plain collect draws on the CPU for a kernel
    seed (its generator, not the kernels' Philox)."""
    from marlnav_tpu_torch.utils.seeding import make_generator

    def draw(seed, envs, steps, n_draws, device):
        return torch.rand((steps, n_draws, envs),
                          generator=make_generator(int(seed), "cpu"))

    return draw


def test_a_cpu_run_of_the_cell_is_correct(cpu_uniforms):
    """A toy-sized run through the harness (8 envs, buffer 20, 3 epochs):
    the port's fused route (its kernels' plain versions here) followed
    repeat by repeat by the reference.  The env rows, counts and mean
    return agree bit for bit; the losses and updates to rounding, within
    the tolerances of the other train cells' CPU runs."""
    from benchmark.harness import runner

    sizes = {"traffic": {"envs": 8},
             "model": {"buffer_len": 20, "batch_size": 20, "num_epochs": 3}}
    result = runner.run_cell(CELL, 2 ** 31 + 77, 0.05, False, "cpu", 0.0,
                             uniforms_fn=cpu_uniforms, sizes=sizes)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    checks.update(result["readings"])
    assert result["correct"]
    assert checks["rows_gap"] == 0.0
    assert checks["counts_gap"] == 0.0 and checks["mean_rew_gap"] == 0.0
    for k in ("actor_loss_gap_all_steps", "critic_loss_gap_all_steps"):
        assert checks[k] < 1e-5, k
    for k in ("actor_update_gap", "critic_update_gap_worst_leaf",
              "adam_m_gap", "adam_v_gap"):
        assert checks[k] < 1e-4, k


def _start(config, envs, seed):
    gen = torch.Generator().manual_seed(seed)
    weights = inputs.initial_weights(gen, inputs.network_shapes(config),
                                     "cpu")
    rows = inputs.initial_rows(gen, config, envs, "cpu")
    # Counters late in an episode, so that a short run crosses resets.
    rows["misc"][0] = torch.arange(envs, dtype=torch.float32) % 40 + 160
    return weights, rows


def test_the_ports_plain_collect_equals_the_reference_at_17_obstacles():
    """Every row, record and count of a 60-step collect of 16 envs, bit
    for bit, across resets."""
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops.fused_collect import (RowState,
                                                     _affine_compose,
                                                     collect_rows_reference)
    from marlnav_tpu_torch.ops.step_math import StepMath

    config, envs, steps = _config(), 16, 60
    weights, rows = _start(config, envs, 3)
    ep, icfg, norm, scal, _ = inputs.port_configs(config, envs)
    sm = StepMath(ep, icfg, norm, scal)
    assert (sm.o, sm.obs_size) == (OBSTACLES, OBS)
    actor = Actor(OBS, HIDDEN)
    inputs.load_weights(actor, weights["actor"])
    u = torch.rand((steps, sm.n_draws, envs),
                   generator=torch.Generator().manual_seed(5))
    port = collect_rows_reference(sm, RowState(*(rows[k] for k in
                                                 ROW_FIELDS)),
                                  *_affine_compose(actor), u)
    step = EnvStep(config["env"], config["init"], config["normalizer"],
                   config["scaler"])
    assert step.n_draws == sm.n_draws == 6 + 2 * OBSTACLES
    final, buf, counts = ref_mappo.collect(step, rows, weights["actor"], u)
    for k, x in zip(ROW_FIELDS, port.rows.fields()):
        assert torch.equal(final[k], x), k
    for k in ("obs", "actions", "log_probs", "rewards", "done"):
        assert torch.equal(buf[k], getattr(port, k)), k
    assert buf["obs"].shape == (steps, envs, AGENTS, OBS)
    assert counts.tolist() == port.stats.tolist()
    assert int(buf["done"].sum()) > 0  # the run crosses resets


def _critic_rows(n, seed=11):
    """Critic weights in ``nn.Linear``'s draw and N rows of In 120 in
    float64, the old values at least a tenth of eps from the value clip's
    edges (where float32 and float64 could take different sides)."""
    n_in, eps = AGENTS * OBS, 0.01
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    bound = lambda fan: 1.0 / fan ** 0.5  # noqa: E731
    w = {"fc1.weight": (torch.rand((HIDDEN, n_in), generator=g, dtype=f64)
                        * 2 - 1) * bound(n_in),
         "fc1.bias": (torch.rand(HIDDEN, generator=g, dtype=f64) * 2 - 1)
         * bound(n_in),
         "fc2.weight": (torch.rand((1, HIDDEN), generator=g, dtype=f64)
                        * 2 - 1) * bound(HIDDEN),
         "fc2.bias": (torch.rand(1, generator=g, dtype=f64) * 2 - 1)
         * bound(HIDDEN)}
    x = torch.rand((n, n_in), generator=g, dtype=f64) * 2 - 1
    v = ref_mappo.critic_forward(w, x)[:, 0]
    # |v - vold| in [0, 0.9 eps] (inside the clip) or [1.1, 3] eps.
    off = torch.rand(n, generator=g, dtype=f64)
    off = torch.where(off < 0.5, off * 1.8, 1.1 + (off - 0.5) * 3.8) * eps
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    vold = v + sign.to(f64) * off
    ret = v + torch.randn(n, generator=g, dtype=f64) * 0.05
    return w, x, vold, ret, eps


def test_the_plain_critic_gradient_agrees_with_the_reference_at_in_120():
    """The port's plain critic gradient (``critic_grad_sums_reference``,
    the kernels' plain version) at In 120 / H 50 over the rows' mean,
    against the reference's float64 autograd gradient: in float64 to
    1e-10 of each output's largest magnitude, in float32 to 1e-5."""
    from marlnav_tpu_torch.ops.update_math import critic_grad_sums_reference

    n = 4000
    w, x, vold, ret, eps = _critic_rows(n)
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss = ref_mappo.critic_loss(leaves, x, vold, ret, eps)
    want = [float(loss.detach())] + list(torch.autograd.grad(
        loss, [leaves[k] for k in ref_mappo.CRITIC_KEYS]))
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        args = [w[k].to(dtype) for k in ref_mappo.CRITIC_KEYS]
        sums = critic_grad_sums_reference(*args, x.to(dtype), vold.to(dtype),
                                          ret.to(dtype), eps)
        assert sums[1].shape == (HIDDEN, AGENTS * OBS)
        got = [float(sums[0]) / n] + [s.double() / n for s in sums[1:]]
        assert abs(got[0] - want[0]) <= tol * abs(want[0]), dtype
        for k, mine, theirs in zip(ref_mappo.CRITIC_KEYS, got[1:], want[1:]):
            scale = float(theirs.abs().max())
            assert float((mine - theirs).abs().max()) <= tol * scale, (
                dtype, k)


RT_FORWARD = ("void marlnav::update::rt_forward_kernel<{}, false>"
              "(marlnav::update::RtArgs)")
RT_BACKWARD = ("void marlnav::update::rt_backward_kernel<{}, false>"
               "(marlnav::update::RtArgs)")
REDUCE = ("marlnav::update::reduce_partials_kernel(float const*, int, int, "
          "float*)")


def _ctx(table):
    work = DeviceWork(table, busy_s=0.2, window_s=0.21, idle_gaps=[])
    shapes = {"envs": 1024, "steps": 1000, "minibatch_steps": 999,
              "agents": AGENTS, "obs": OBS, "hidden": HIDDEN,
              "obstacles": OBSTACLES, "actor_epochs": 50,
              "critic_epochs": 50}
    return Context(work, [0.05], 4, shapes)


def test_the_route_s_roofline_reader_on_a_canned_table():
    """The critic's forward and backward (``kActor`` false) and its share
    of the reductions give the share; the templated critic kernel, the
    actor's run-time route (``kActor`` true) and the actor's own kernel
    are not counted; an empty table gives nothing."""
    read = spec.metric_reader("critic_rt_grad_roofline_pct")
    rows = 999 * 1024
    least = (rows * (4 * 120 + 8) + 4 * (2 * (50 * 120 + 2 * 50 + 1) + 1)
             ) / 3.35e12
    assert least > rows * (4 * 120 * 50 + 10 * 50 + 30) / 495e12
    route = [(RT_FORWARD.format("false"), 200, 0.20),
             (RT_BACKWARD.format("false"), 200, 0.12),
             (REDUCE, 200, 0.004)]
    want = 100 * least / ((0.20 + 0.12 + 0.004) / 200)
    assert read(_ctx(route)) == pytest.approx(want, rel=1e-9)
    others = [("void marlnav::update::tc_grad_kernel<marlnav::update::"
               "CriticHead<7>, 5>(marlnav::update::GradArgs)", 200, 0.05),
              (RT_FORWARD.format("true"), 100, 0.07),
              (RT_BACKWARD.format("true"), 100, 0.09),
              ("marlnav::update::actor_grad_kernel(marlnav::update::"
               "ActorArgs)", 200, 0.03)]
    # The reductions now come from 200 + 200 + 100 launches; the route's
    # 200 take their mean.
    mixed = route[:2] + [(REDUCE, 500, 0.010)] + others
    want_mixed = 100 * least / ((0.20 + 0.12 + 0.010 * 200 / 500) / 200)
    assert read(_ctx(mixed)) == pytest.approx(want_mixed, rel=1e-9)
    assert read(_ctx(others)) is None
    assert read(_ctx([])) is None


RT_ONE_PASS = ("void marlnav::update::rt_forward_kernel<{}, false, true>"
               "(marlnav::update::RtArgs)")


def test_the_route_s_roofline_reader_on_one_pass_launches():
    """Where the route takes one pass (In 120 / H 50: the one-pass
    instance of ``rt_forward_kernel`` and the reduction, no backward), the
    share comes from the critic's one-pass launches and its share of the
    reductions alone; the actor's one-pass instance (``kActor`` true) is
    not counted."""
    read = spec.metric_reader("critic_rt_grad_roofline_pct")
    rows = 999 * 1024
    least = (rows * (4 * 120 + 8) + 4 * (2 * (50 * 120 + 2 * 50 + 1) + 1)
             ) / 3.35e12
    route = [(RT_ONE_PASS.format("false"), 200, 0.26), (REDUCE, 200, 0.004)]
    want = 100 * least / ((0.26 + 0.004) / 200)
    assert read(_ctx(route)) == pytest.approx(want, rel=1e-9)
    actor = [(RT_ONE_PASS.format("true"), 100, 0.05)]
    mixed = route[:1] + [(REDUCE, 300, 0.006)] + actor
    want_mixed = 100 * least / ((0.26 + 0.006 * 200 / 300) / 200)
    assert read(_ctx(mixed)) == pytest.approx(want_mixed, rel=1e-9)
    assert read(_ctx(actor + [(REDUCE, 100, 0.002)])) is None
