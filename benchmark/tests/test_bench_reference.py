"""The benchmark's plain reference held against the port's plain versions
at toy sizes on the CPU, and against one training repeat of the port's
fused route (its kernels' plain versions on the CPU).  The tests may
import the port; the reference may not."""

import json
import os

import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import compare, philox
from benchmark.reference import returns as ref_returns
from benchmark.reference.env_step import ROW_FIELDS, EnvStep, roll
from benchmark.reference.mappo import (actor_loss, collect, critic_loss,
                                       minibatch_slices)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name="marlnav_default"):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("ctr, key, words", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, words):
    """Random123's known-answer vectors for Philox4x32-10."""
    args = [torch.tensor(v, dtype=torch.int64) for v in ctr + key]
    assert tuple(int(w) for w in philox.philox4x32_10(*args)) == words


def test_uniforms_slots():
    """Draw 4 d + q of step t, env p is word q of counter (t, d, 0, 0)
    under key (seed, p)."""
    seed, envs, steps = 0x9abcdef1, 5, 3
    u = philox.uniforms(seed, envs, steps, 12, "cpu", step_chunk=2)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    for t, d, p in ((0, 0, 0), (2, 2, 4), (1, 1, 3)):
        words = philox.philox4x32_10(i64(t), i64(d), i64(0), i64(0),
                                     i64(seed), i64(p))
        for q in range(4):
            assert u[t, 4 * d + q, p] == philox.bits_to_uniform(words[q])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    edge = torch.tensor([0, 0x7fffffff, 0x80000000, 0xffffffff])
    assert philox.bits_to_uniform(edge).tolist() == [
        0.5, 1.0 - 2 ** -24, 0.0, 0.5 - 2 ** -24]


def _port_step(config, envs):
    ep, icfg, norm, scal, _ = inputs.port_configs(config, envs)
    from marlnav_tpu_torch.ops.step_math import StepMath

    return StepMath(ep, icfg, norm, scal)


def _start(config, envs, seed):
    gen = torch.Generator().manual_seed(seed)
    weights = inputs.initial_weights(gen, inputs.network_shapes(config),
                                     "cpu")
    rows = inputs.initial_rows(gen, config, envs, "cpu")
    # Counters late in an episode, so that a short run crosses resets.
    rows["misc"][0] = torch.arange(envs, dtype=torch.float32) % 40 + 160
    return weights, rows


@pytest.mark.parametrize("name", ["marlnav_default", "marlnav_curriculum"])
def test_collect_equals_the_ports_plain_collect(name):
    """Every row, record and count of a collect, bit for bit."""
    from marlnav_tpu_torch.ops.fused_collect import (RowState,
                                                     _affine_compose,
                                                     collect_rows_reference)
    from marlnav_tpu_torch.models import Actor

    config, envs, steps = _config(name), 16, 60
    weights, rows = _start(config, envs, 3)
    sm = _port_step(config, envs)
    actor = Actor(12, 50)
    inputs.load_weights(actor, weights["actor"])
    u = torch.rand((steps, sm.n_draws, envs),
                   generator=torch.Generator().manual_seed(5))
    port = collect_rows_reference(sm, RowState(*(rows[k] for k in
                                                 ROW_FIELDS)),
                                  *_affine_compose(actor), u)
    step = EnvStep(config["env"], config["init"], config["normalizer"],
                   config["scaler"])
    final, buf, counts = collect(step, rows, weights["actor"], u)
    for k, x in zip(ROW_FIELDS, port.rows.fields()):
        assert torch.equal(final[k], x), k
    for k in ("obs", "actions", "log_probs", "rewards", "done"):
        assert torch.equal(buf[k], getattr(port, k)), k
    assert counts.tolist() == port.stats.tolist()
    assert int(buf["done"].sum()) > 0  # the run crosses resets


@pytest.mark.parametrize("deterministic", [False, True])
def test_rollout_equals_the_ports_plain_rollout(deterministic):
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops.fused_collect import RowState, _affine_compose
    from marlnav_tpu_torch.ops.fused_rollout import rollout_rows_reference

    config, envs, steps = _config(), 12, 40
    weights, rows = _start(config, envs, 4)
    sm = _port_step(config, envs)
    actor = Actor(12, 50)
    inputs.load_weights(actor, weights["actor"])
    u = torch.rand((steps, sm.n_draws, envs),
                   generator=torch.Generator().manual_seed(6))
    port_rows, port_rewards = rollout_rows_reference(
        sm, RowState(*(rows[k] for k in ROW_FIELDS)),
        *_affine_compose(actor), u, deterministic)
    step = EnvStep(config["env"], config["init"], config["normalizer"],
                   config["scaler"])
    rewards = torch.empty(steps, envs)

    def on_step(t, rec):
        rewards[t] = rec["reward"]

    final = roll(step, rows, weights["actor"], u, deterministic, on_step)
    assert torch.equal(rewards, port_rewards)
    assert compare.rows_gap(final, dict(zip(ROW_FIELDS,
                                            port_rows.fields()))) == 0.0


def test_returns_equal_the_ports():
    from marlnav_tpu_torch.algo.mappo import reference_returns
    from marlnav_tpu_torch.config import MAPPOConfig
    from marlnav_tpu_torch.ops.returns import (
        discounted_returns_reference, gae_advantages_reference)

    g = torch.Generator().manual_seed(7)
    rewards = torch.randn((50, 9), generator=g) * 100
    done = torch.rand((50, 9), generator=g) < 0.1
    values = torch.randn((50, 9), generator=g)
    last = torch.randn(9, generator=g)
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(
            ref_returns.discounted_returns(rewards, done, 0.9, dtype),
            discounted_returns_reference(rewards, done, 0.9, dtype))
    assert torch.equal(
        ref_returns.gae_advantages(rewards, done, values, last, 0.99, 0.95),
        gae_advantages_reference(rewards, done, values, last, 0.99, 0.95))
    for f64 in (False, True):
        normed, mean = ref_returns.normalized_returns(rewards, done, 0.9, f64)
        cfg = MAPPOConfig(num_parallel=9, buffer_len=50, batch_size=50,
                          num_total=450, returns_f64=f64)
        p_normed, p_mean = reference_returns(rewards, done, cfg)
        assert torch.equal(normed, p_normed) and torch.equal(mean, p_mean)


def test_minibatch_slices_drop_the_last_step_when_faithful():
    assert minibatch_slices(1000, 1000, True) == [(0, 999)]
    assert minibatch_slices(1000, 250, True)[-1] == (750, 249)
    assert minibatch_slices(200, 200, False) == [(0, 200)]


@pytest.mark.parametrize("faithful", [True, False])
def test_losses_and_gradients_match_the_ports_autograd(faithful):
    """The reference's float64 losses and gradients against the port's
    own losses through autograd in float64."""
    from marlnav_tpu_torch.algo.mappo import (Buffer, actor_loss as p_actor,
                                              critic_loss as p_critic,
                                              minibatch_advantages)
    from marlnav_tpu_torch.config import MAPPOConfig
    from marlnav_tpu_torch.models import Actor, Critic

    t, p, a, f = 6, 5, 3, 12
    g = torch.Generator().manual_seed(8)
    f64 = torch.float64
    obs = torch.rand((t, p, a, f), generator=g, dtype=f64) * 2 - 1
    actions = torch.randn((t, p, a, 2), generator=g, dtype=f64)
    log_probs = torch.randn((t, p * a), generator=g, dtype=f64) - 2
    values = torch.randn((t, p, 1), generator=g, dtype=f64)
    rets = torch.randn((t, p), generator=g, dtype=f64)
    buf = Buffer(obs, actions, log_probs, values, rets,
                 torch.zeros((t, p), dtype=torch.bool))
    cfg = MAPPOConfig(num_parallel=p, buffer_len=t, batch_size=t,
                      num_total=t * p, epsilon=0.2, ent_const=0.01,
                      faithful=faithful)
    weights, _ = _start(_config(), 1, 9)
    actor, critic = Actor(f, 50).double(), Critic(f, a, 50).double()
    inputs.load_weights(actor, {k: v.double()
                                for k, v in weights["actor"].items()})
    inputs.load_weights(critic, {k: v.double()
                                 for k, v in weights["critic"].items()})
    adv = minibatch_advantages(buf, cfg)
    want_a = p_actor(actor, buf, cfg, adv)
    want_c = p_critic(critic, buf, cfg)
    ga = torch.autograd.grad(want_a, list(actor.parameters()))
    gc = torch.autograd.grad(want_c, list(critic.parameters()))
    wa = {k: v.detach().clone().requires_grad_()
          for k, v in actor.named_parameters()}
    wc = {k: v.detach().clone().requires_grad_()
          for k, v in critic.named_parameters()}
    d = (rets - values[..., 0]).reshape(-1)
    my_adv = d.repeat(a) if faithful else torch.repeat_interleave(d, a)
    got_a = actor_loss(wa, obs.reshape(-1, f), actions.reshape(-1, 2),
                       log_probs.reshape(-1), my_adv, 0.2, 0.01)
    got_c = critic_loss(wc, obs.reshape(-1, a * f), values.reshape(-1),
                        rets.reshape(-1), 0.2)
    assert torch.allclose(got_a, want_a, rtol=1e-12, atol=0)
    assert torch.allclose(got_c, want_c, rtol=1e-12, atol=0)
    for mine, theirs in zip(torch.autograd.grad(got_a, list(wa.values())),
                            ga):
        assert torch.allclose(mine, theirs, rtol=1e-10, atol=1e-14)
    for mine, theirs in zip(torch.autograd.grad(got_c, list(wc.values())),
                            gc):
        assert torch.allclose(mine, theirs, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", ["default.train", "curriculum.train",
                                  "default.rollout"])
def test_a_cpu_run_of_each_cell_is_correct(name, cpu_uniforms):
    """One run of each cell at a toy size through the harness: the port's
    fused route (its kernels' plain versions here) followed repeat by
    repeat by the reference.  The env rows, counts and mean return agree
    bit for bit; the losses and updates to rounding."""
    from benchmark.harness import runner

    sizes = {"default.train": {"traffic": {"envs": 8},
                               "model": {"buffer_len": 20, "batch_size": 20,
                                         "num_epochs": 3}},
             "curriculum.train": {"traffic": {"envs": 8, "block": 4},
                                  "model": {"buffer_len": 20,
                                            "batch_size": 20,
                                            "num_epochs": 3}},
             "default.rollout": {"traffic": {"envs": 8, "steps": 20}}}[name]
    result = runner.run_cell(name, 2 ** 31 + 77, 0.05, False, "cpu", 0.0,
                             uniforms_fn=cpu_uniforms, sizes=sizes)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    checks.update(result["readings"])
    assert result["correct"]
    assert checks["rows_gap"] == 0.0
    if name.endswith("train"):
        assert checks["counts_gap"] == 0.0 and checks["mean_rew_gap"] == 0.0
        for k in ("actor_loss_gap_all_steps", "critic_loss_gap_all_steps"):
            assert checks[k] < 1e-5, k
        for k in ("actor_update_gap", "critic_update_gap_worst_leaf",
                  "adam_m_gap", "adam_v_gap"):
            assert checks[k] < 1e-4, k
    else:
        assert checks["reward_gap"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["collect", "rollout"])
def test_the_reference_equals_the_kernels_on_the_card(cuda, kernel):
    """On the card the reference (its step replayed as a CUDA graph, its
    uniforms from Philox) gives the kernels' bits."""
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.ops.fused_collect import (RowState,
                                                     _affine_compose,
                                                     fused_collect_rows)
    from marlnav_tpu_torch.ops.fused_rollout import fused_rollout_rows

    config, envs, steps, seed = _config(), 1000, 300, 2 ** 31 + 5
    weights, rows = _start(config, envs, 11)
    weights = {k: v.to(cuda) for k, v in weights["actor"].items()}
    rows = {k: v.to(cuda) for k, v in rows.items()}
    sm = _port_step(config, envs)
    actor = Actor(12, 50).to(cuda)
    inputs.load_weights(actor, weights)
    port_rows = RowState(*(rows[k] for k in ROW_FIELDS))
    step = EnvStep(config["env"], config["init"], config["normalizer"],
                   config["scaler"])
    u = philox.uniforms(seed, envs, steps, step.n_draws, cuda)
    if kernel == "collect":
        out = fused_collect_rows(sm, port_rows, *_affine_compose(actor),
                                 seed, steps)
        final, buf, counts = collect(step, rows, weights, u)
        for k in ("obs", "actions", "log_probs", "rewards", "done"):
            assert torch.equal(buf[k], getattr(out, k)), k
        assert counts.tolist() == out.stats.tolist()
        out_rows = out.rows
    else:
        out_rows, out_rewards = fused_rollout_rows(
            sm, port_rows, *_affine_compose(actor), seed, steps, False)
        rewards = torch.empty_like(out_rewards)

        def on_step(t, rec):
            rewards[t] = rec["reward"]

        final = roll(step, rows, weights, u, False, on_step)
        assert torch.equal(rewards, out_rewards)
    assert compare.rows_gap(final, dict(zip(ROW_FIELDS,
                                            out_rows.fields()))) == 0.0
