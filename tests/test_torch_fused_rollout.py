"""The fused rollout's plain PyTorch version against the JAX package's
Pallas rollout kernel (interpret mode, host-injected uniforms), its CPU
routing, and the bench entry point on the CPU.

Both sides consume the same uniforms: the JAX kernel takes them in its
tile layout (T, n_draws, 8, P/8), the port in (T, n_draws, P), mapped by
``noise_per_env``.  Both run the same float32 step math, so the
differences are last-ulp ones between two frameworks' tanh/log/exp.

Tolerances (those of tests/test_ops.py:96-103 for one step): rewards rtol
1e-5 / atol 1e-3 (rewards are sums of terms of magnitude ~500); the final
agent states and obstacles rtol 1e-5 / atol 1e-3 (positions ~1e3; XLA
rounds a reset draw's ``(u - 0.5) * range + mean`` one ulp apart from
PyTorch); target, step counter and latch exactly.  Multi-step cases use ``tame_policy``: an
untamed random actor steers up to +-pi per step and amplifies ulp
differences chaotically within a few steps (tests/test_ops.py:84-118), so
the untamed case is one step.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against
this plain version and against the collect kernel on the card, and so
does ``tests_cuda/test_cuda_fused_rollout.py``, which chip_smoke.py runs.
"""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.models import actor_init, critic_init
from marlnav_tpu.ops import env_state_to_rows as j_env_state_to_rows
from marlnav_tpu.ops import make_fused_rollout as j_make_fused_rollout
from marlnav_tpu_torch import bench
from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig,
                                      mock_init_scenario)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, from_jax_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_rollout as fr
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator
from test_torch_fused_collect import noise_per_env, tame_policy

P, A, O = 1024, 3, 3
MODES = {"sampled": False, "policy-mean": True}
_TS = collections.namedtuple("_TS", "actor")


def run_both(t, deterministic, episode_len=200, noisy=False, tame=True):
    """One t-step rollout through the JAX kernel (interpret mode) and the
    port's rollout (CPU: the plain version), from the same state, weights
    and uniforms.  Returns ``((rows, rewards) JAX, (rows, rewards) port,
    the JAX start rows)``."""
    ep_kw = dict(num_parallel=P, num_agents=A, episode_len=episode_len)
    ic_kw = dict(num_parallel=P, num_obstacles=O, noisy_ags=noisy)
    j_ep, j_ic = JEnvParams(**ep_kw), JTriangleInit(**ic_kw)
    rows0 = j_env_state_to_rows(
        j_make_env(j_ep, j_ic, None).init(jax.random.PRNGKey(0)))
    actor = actor_init(jax.random.PRNGKey(1), j_ep.obs_size, 50, 2)
    if tame:
        actor = tame_policy(_TS(actor)).actor
    n_draws = 2 * A + 2 * O + (3 * A if noisy else 0)
    noise = jax.random.uniform(jax.random.PRNGKey(5), (t, n_draws, 8, P // 8),
                               jnp.float32)
    j_roll = j_make_fused_rollout(
        j_ep, j_ic, JNormalizerConfig(num_agents=A), JScalerConfig(), t,
        deterministic_actions=deterministic, interpret=True, noise_input=True)
    j_out = j_roll(rows0, actor, 7, noise=noise)

    t_actor, _ = from_jax_params(jax.tree.map(np.asarray, (
        actor, critic_init(jax.random.PRNGKey(2), j_ep.obs_size, A, 50))))
    t_roll = fr.make_fused_rollout(
        EnvParams(**ep_kw), TriangleInitConfig(**ic_kw),
        NormalizerConfig(num_agents=A), ScalerConfig(), t,
        deterministic_actions=deterministic, device="cpu")
    t_rows0 = fr.RowState(*(torch.tensor(np.asarray(x)) for x in rows0))
    t_out = t_roll(t_rows0, t_actor, 7,
                   noise=torch.tensor(noise_per_env(noise)))
    return j_out, t_out, rows0


def assert_rollouts_match(j_out, t_out):
    (j_rows, j_rew), (t_rows, t_rew) = j_out, t_out
    assert t_rew.shape == j_rew.shape
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=1e-5,
                               atol=1e-3, err_msg="rewards")
    t_arr = fr.rows_to_env_arrays(t_rows)
    j_arr = fr.rows_to_env_arrays(fr.RowState(
        *(torch.tensor(np.asarray(x)) for x in j_rows)))
    for name, got, want in zip(("states", "obstacles"), t_arr, j_arr):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    for name, got, want in zip(("target", "step_num", "latch"), t_arr[2:],
                               j_arr[2:]):
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_rollout_matches_jax_kernel(mode):
    """T=10 tamed: rewards and the final state match."""
    j_out, t_out, _ = run_both(10, MODES[mode])
    assert_rollouts_match(j_out, t_out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_rollout_one_step_untamed(mode):
    """One step of a random (untamed) actor: the per-step math contract at
    full steering (tests/test_ops.py:84)."""
    j_out, t_out, _ = run_both(1, MODES[mode], tame=False)
    assert_rollouts_match(j_out, t_out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_rollout_through_resets(mode):
    """episode_len=4, T=8, noisy_ags: every env truncates at steps 3 and 7
    and redraws obstacles, positions and headings from the reset uniforms,
    which stay at slot 2A in the policy-mean mode too
    (marlnav_tpu/ops/fused_rollout.py:228-257); an off-by-2A read shows in
    the final state."""
    j_out, t_out, rows0 = run_both(8, MODES[mode], episode_len=4, noisy=True)
    assert (np.asarray(j_out[0].misc[0]) == 0).all()  # premise: all reset
    assert not np.array_equal(np.asarray(j_out[0].obx), np.asarray(rows0.obx))
    assert_rollouts_match(j_out, t_out)


def _cpu_case(t=6, p=32, episode_len=3, noisy=True):
    ep = EnvParams(num_parallel=p, episode_len=episode_len)
    ic = TriangleInitConfig(num_parallel=p, noisy_ags=noisy)
    sm = StepMath(ep, ic, NormalizerConfig(), ScalerConfig())
    rows = fr.env_state_to_rows(make_env(ep, ic, "cpu").init(
        make_generator(1)))
    actor = Actor(ep.obs_size, 50, generator=torch.Generator().manual_seed(2))
    a_comp, c_comp = fr._affine_compose(actor)
    noise = torch.rand((t, sm.n_draws, p), generator=make_generator(3))
    return ep, ic, sm, rows, actor, a_comp, c_comp, noise


def test_rollout_shares_the_collects_step_and_draw_slots():
    """The sampled rollout is the collect on the same uniforms (rewards and
    final state exactly), and the policy-mean rollout reads only the reset
    slots [2A, n_draws): changing the action slots leaves it unchanged,
    changing the reset slots changes it once envs reset."""
    _, _, sm, rows, _, a_comp, c_comp, noise = _cpu_case()
    col = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
    rows_s, rew_s = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                              False)
    assert torch.equal(rew_s, col.rewards)
    assert all(torch.equal(x, y) for x, y in zip(rows_s.fields(),
                                                 col.rows.fields()))
    base = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise, True)
    for lo, hi, changes in ((0, 2 * sm.a, False), (2 * sm.a, sm.n_draws, True)):
        other = noise.clone()
        other[:, lo:hi] = 1.0 - other[:, lo:hi]
        got = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, other, True)
        same = torch.equal(got[1], base[1]) and all(
            torch.equal(x, y) for x, y in zip(got[0].fields(), base[0].fields()))
        assert same != changes, (lo, hi)


def test_cpu_routing_runs_plain_version_and_launches_nothing(monkeypatch):
    """On CPU tensors the wrapper runs the plain version on uniforms drawn
    from a generator seeded with ``seed`` and launches nothing; other
    devices raise, as do mock scenarios, rows on another device than the
    rollout's, and the default device without CUDA."""
    ep, ic, sm, rows, actor, a_comp, c_comp, _ = _cpu_case()
    t = 6
    roll = fr.make_fused_rollout(ep, ic, NormalizerConfig(), ScalerConfig(), t,
                                 device="cpu")
    got_rows, got_rew = roll(rows, actor, 9)
    uniforms = torch.rand((t, sm.n_draws, rows.px.shape[-1]),
                          generator=make_generator(9))
    want_rows, want_rew = fr.rollout_rows_reference(sm, rows, a_comp, c_comp,
                                                    uniforms, False)
    assert torch.equal(got_rew, want_rew)
    assert all(torch.equal(x, y) for x, y in zip(got_rows.fields(),
                                                 want_rows.fields()))
    assert int((want_rows.misc[0] == 0).sum()) > 0  # resets fired
    assert fr.fused_rollout_rows.launches == 0
    meta = fr.RowState(*(x.to("meta") for x in rows.fields()))
    with pytest.raises(ValueError, match="unsupported device"):
        fr.fused_rollout_rows(sm, meta, a_comp, c_comp, 9, t, False)
    with pytest.raises(ValueError, match="built for cpu"):
        roll(meta, actor, 9)
    with pytest.raises(NotImplementedError, match="triangle"):
        fr.make_fused_rollout(ep, mock_init_scenario(0), NormalizerConfig(),
                              ScalerConfig(), t, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fr.make_fused_rollout(ep, ic, NormalizerConfig(), ScalerConfig(), t)


def test_bench_on_the_cpu(capsys, monkeypatch):
    """``python -m marlnav_tpu_torch.bench --device cpu --plain`` at a tiny
    size prints one JSON line with a positive rate and runs no kernel;
    without ``--device cpu`` and without CUDA it raises."""
    result = bench.main(["--device", "cpu", "--plain", "--num-envs", "16",
                         "--num-steps", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "value", "unit"}
    assert line["metric"] == "env_steps_per_s" and line["value"] > 0
    assert set(result["routes"]) == {"fused", "plain"}
    assert all(np.isfinite(v) for v in result["mean_rewards"].values())
    assert fr.fused_rollout_rows.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--num-envs", "16", "--num-steps", "4"])
