"""The port's plain versions at the widths past the kernels' template
instances, against the JAX package, on the CPU.

On the card these widths run the kernels' run-time routes (the step
kernels' run-time obstacle count, the gradient kernels' run-time-width
route), which tests_cuda/test_cuda_widths.py holds against these plain
versions: bit for bit for the step, against float64 and the bf16 gap for
the gradients.  Here the plain versions are held against the JAX package
itself, with no interpret mode at these widths:

* the collect's plain step at 9, 17 and 32 obstacles against the JAX
  env's ``step`` (the port's actions scaled and fed to it): one step of an
  untamed actor from a spread-out state, and a tamed 8-step run from the
  triangle init, in which no env finishes; observations rtol 1e-4 / atol
  5e-4 (view angles near dot ~ 1), rewards rtol 1e-4 / atol 1e-3, done
  exactly, the state where no env finished rtol 1e-5 / atol 1e-3 (the
  tolerances of tests/test_torch_fused_collect.py);
* the plain critic and un-collapsed actor gradients at the widths the
  run-time-width route is timed at on the card: critic (In 120, H 50)
  (-no 17), (In 210, H 64), (In 36, H 512) (-hs 512), (In 102, H 257) and
  (In 1041, H 64) (past 1,000 columns), actor (F 40, H 50) (-no 17), (F
  70, H 128) and (F 12, H 512), against ``jax.value_and_grad`` of the JAX
  package's losses (XLA): losses rtol 1e-5, gradients rtol 1e-4 / atol
  1e-6 (float32 sums in another order, tests/test_torch_mappo.py's
  tolerances);
* with ``--bf16-updates`` the plain critic at (In 36, H 64), the width
  ``-hs 64`` trains through the run-time route's bf16 kernels, against the
  JAX package's staged critic kernel in interpret mode with and without
  bf16, as tests/test_torch_bf16.py holds the routes: each output within a
  quarter of the JAX route's own bf16 - float32 gap.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import Buffer as JBuffer
from marlnav_tpu.algo import mappo as jm
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.env.types import EnvState as JEnvState
from marlnav_tpu.env.types import EpisodeStats as JEpisodeStats
from marlnav_tpu.models import actor_init, critic_init
from marlnav_tpu.utils.transforms import make_action_scaler
from marlnav_tpu.utils.transforms import make_obs_normalizer
from marlnav_tpu_torch.algo import mappo as tm
from marlnav_tpu_torch.algo.mappo import Buffer
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.models import from_jax_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator

from test_torch_bf16 import (assert_bf16_route, cfgs, jax_out, networks,
                             port_out)
from test_torch_bf16 import rand_buffer as bf16_buffer
from test_torch_fused_collect import tame_policy

P, A = 64, 3


def spread_state(rng, o):
    """A numpy env state of P envs and o obstacles spread over the arena,
    a quarter of the envs' agents clustered near the obstacles' middle and
    a quarter near the target, step counters and latches at random."""
    ang = rng.uniform(-np.pi, np.pi, size=(P, A))
    states = np.concatenate([
        rng.uniform([0, 0], [1500, 750], size=(P, A, 2)),
        np.stack([np.cos(ang), np.sin(ang)], -1),
        rng.uniform(3.0, 10.0, size=(P, A, 1))], axis=2)
    states[: P // 4, :, :2] = (np.array([750.0, 375.0])
                               + rng.normal(scale=60.0, size=(P // 4, A, 2)))
    states[P // 4: P // 2, :, :2] = (np.array([1350.0, 375.0])
                                     + rng.normal(scale=15.0,
                                                  size=(P // 4, A, 2)))
    obstacles = rng.uniform([500, 250], [1000, 500], size=(P, o, 2))
    target = np.broadcast_to(np.array([1350.0, 375.0]), (P, 1, 2))
    step_num = rng.integers(0, 200, size=P).astype(np.int32)
    latch = rng.uniform(size=P) < 0.2
    return (states.astype(np.float32), obstacles.astype(np.float32),
            target.astype(np.float32).copy(), step_num, latch)


def setup(o):
    ep = dict(num_parallel=P, num_obstacles=o)
    ic = dict(num_parallel=P, num_obstacles=o)
    j_env = j_make_env(JEnvParams(**ep), JTriangleInit(**ic), None)
    sm = StepMath(EnvParams(**ep), TriangleInitConfig(**ic),
                  NormalizerConfig(num_obstacles=o), ScalerConfig())
    return j_env, sm


def run_plain(sm, arrays, actor, t, seed):
    """The collect's plain version for t steps from the numpy state."""
    state = EnvState(*(torch.tensor(np.asarray(x)) for x in arrays),
                     EpisodeStats.zeros("cpu"), make_generator(0))
    uniforms = np.random.default_rng(seed).uniform(
        size=(t, sm.n_draws, P)).astype(np.float32)
    a_comp, c_comp = fc._affine_compose(actor)
    return fc.fused_collect_rows(sm, fc.env_state_to_rows(state), a_comp,
                                 c_comp, 0, t, torch.tensor(uniforms))


class _TS(NamedTuple):
    actor: object


def actors(o, tame):
    ja = actor_init(jax.random.PRNGKey(o), 6 + 2 * o, 50, 2)
    if tame:
        ja = tame_policy(_TS(ja)).actor
    jc = critic_init(jax.random.PRNGKey(o + 1), 6 + 2 * o, A, 50)
    return from_jax_params(jax.tree.map(np.asarray, (ja, jc)))[0]


def step_jax(j_env, o, state, out, t):
    """JAX's normalized pre-step obs, then its step on the port's scaled
    actions; returns (obs, next state, step output)."""
    obs = make_obs_normalizer(JNormalizerConfig(num_obstacles=o))(
        j_env.observations(state))
    actions = make_action_scaler(JScalerConfig())(
        jnp.asarray(out.actions[t].numpy()))
    state, j_out = j_env.step(state, actions)
    return obs, state, j_out


def assert_step_close(obs, j_out, out, t):
    np.testing.assert_allclose(out.obs[t].numpy(), np.asarray(obs),
                               rtol=1e-4, atol=5e-4, err_msg=f"obs {t}")
    np.testing.assert_allclose(out.rewards[t].numpy(),
                               np.asarray(j_out.rewards), rtol=1e-4,
                               atol=1e-3, err_msg=f"rewards {t}")
    np.testing.assert_array_equal(
        out.done[t].numpy(),
        np.asarray(j_out.terminated | j_out.truncated))


def assert_rows_close(out, j_state, keep):
    states, obstacles, _, step_num, latch = fc.rows_to_env_arrays(out.rows)
    np.testing.assert_allclose(states.numpy()[keep],
                               np.asarray(j_state.states)[keep], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(obstacles.numpy()[keep],
                                  np.asarray(j_state.obstacles)[keep])
    np.testing.assert_array_equal(step_num.numpy()[keep],
                                  np.asarray(j_state.step_num)[keep])
    np.testing.assert_array_equal(latch.numpy(),
                                  np.asarray(j_state.terminates))


@pytest.mark.parametrize("o", [9, 17, 32])
def test_plain_step_matches_jax_env_at_many_obstacles(o):
    """One step of an untamed actor from a spread-out state: obs, rewards
    and done everywhere, the state where no env finished."""
    j_env, sm = setup(o)
    arrays = spread_state(np.random.default_rng(o), o)
    out = run_plain(sm, arrays, actors(o, tame=False), 1, seed=o)
    s0 = JEnvState(*(jnp.asarray(x) for x in arrays), JEpisodeStats.zeros(),
                   jax.random.PRNGKey(1))
    obs, j_state, j_out = step_jax(j_env, o, s0, out, 0)
    assert_step_close(obs, j_out, out, 0)
    keep = ~out.done[0].numpy()
    assert keep.any() and not keep.all()  # premise: some envs reset
    assert_rows_close(out, j_state, keep)


@pytest.mark.parametrize("o", [9, 17, 32])
def test_plain_tamed_run_matches_jax_env_at_many_obstacles(o):
    """8 steps of a tamed actor from the triangle init: no env finishes;
    every step's obs, rewards and done and the final state."""
    j_env, sm = setup(o)
    s0 = j_env.init(jax.random.PRNGKey(o))
    arrays = (s0.states, s0.obstacles, s0.target, s0.step_num,
              s0.terminates)
    out = run_plain(sm, arrays, actors(o, tame=True), 8, seed=o)
    assert not out.done.any()  # premise
    state = s0
    for t in range(8):
        obs, state, j_out = step_jax(j_env, o, state, out, t)
        assert_step_close(obs, j_out, out, t)
    assert_rows_close(out, state, np.ones(P, bool))


T, PB = 12, 4
WIDE = {"critic-in120-h50": ("critic", 40, 50),
        "critic-in210-h64": ("critic", 70, 64),
        "critic-in36-h512": ("critic", 12, 512),
        "critic-in102-h257": ("critic", 34, 257),
        "critic-in1041-h64": ("critic", 347, 64),
        "uncollapsed-f40-h50": ("actor", 40, 50),
        "uncollapsed-f70-h128": ("actor", 70, 128),
        "uncollapsed-f12-h512": ("actor", 12, 512)}


def rand_buffer(seed, obs):
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(T, PB, A, obs)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(T, PB, A, 2)).astype(np.float32),
        log_probs=rng.normal(-1.0, 0.5, size=(T, PB * A)).astype(np.float32),
        values=rng.normal(size=(T, PB, 1)).astype(np.float32),
        returns=rng.normal(size=(T, PB)).astype(np.float32),
        done=rng.uniform(size=(T, PB)) < 0.2)
    return (JBuffer(**{k: jnp.asarray(v) for k, v in b.items()}),
            Buffer(**{k: torch.tensor(v) for k, v in b.items()}))


@pytest.mark.parametrize("width", sorted(WIDE))
def test_plain_gradients_match_jax_at_wide_widths(width):
    """fu.critic_grad / fu.actor_grad_uncollapsed (the plain versions on
    the CPU) against jax.value_and_grad of the JAX package's losses."""
    net, obs, hidden = WIDE[width]
    kw = dict(num_agents=A, num_parallel=PB, obs_size=obs,
              hidden_size=hidden, num_total=T * PB, buffer_len=T,
              num_epochs=1, batch_size=T)
    jc, tc = JMAPPOConfig(**kw), MAPPOConfig(**kw)
    jb, tb = rand_buffer(3, obs)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    ja, jcr = actor_init(k1, obs, hidden, 2), critic_init(k2, obs, A, hidden)
    ta, tcr = from_jax_params(jax.tree.map(np.asarray, (ja, jcr)))
    if net == "critic":
        lj, gj = jax.value_and_grad(jm.critic_loss)(jcr, jb, jc)
        lt, gt = fu.critic_grad(tcr, tb, tc)
        module = tcr
    else:
        lj, gj = jax.value_and_grad(jm.actor_loss)(ja, jb, jc)
        lt, gt = fu.actor_grad_uncollapsed(
            ta, tb, tm.minibatch_advantages(tb, tc), tc)
        module = ta
    assert gt["fc1.weight"].shape == (hidden, obs * (A if net == "critic"
                                                     else 1))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for name, layer in module.named_children():
        for leaf, key in (("w", "weight"), ("b", "bias")):
            got = gt[f"{name}.{key}"].numpy()
            want = np.asarray(getattr(getattr(gj, name), leaf))
            np.testing.assert_allclose(got.T if leaf == "w" else got, want,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{width} {name}.{leaf}")


def test_plain_bf16_critic_matches_jax_at_h64():
    """fu.critic_grad with bf16_updates (the plain version on the CPU) at
    In 36 / H 64 against make_fused_critic_grad in interpret mode, bf16
    and float32, on both minibatch slices: within a quarter of the JAX
    route's gap, output by output."""
    from marlnav_tpu.ops.fused_update import (make_fused_critic_grad,
                                              stage_critic_minibatch)
    p, t = 128, 12
    (_, jcr), (_, tcr) = networks(3, hidden=64)
    jb, tb = bf16_buffer(2, t, p)
    kernels = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16, batch_size=6, hidden_size=64)
        kernels[bf16] = jax.jit(make_fused_critic_grad(jc, interpret=True),
                                static_argnums=2)
    assert tcr.fc1.weight.shape == (64, 36)
    for i, (j_mb, t_mb) in enumerate(zip(jm.minibatch_slices(jb, jc),
                                         tm.minibatch_slices(tb, tc))):
        staged = stage_critic_minibatch(j_mb, jc)
        j = {bf16: jax_out(*k(jcr, *staged)) for bf16, k in kernels.items()}
        port = port_out(*fu.critic_grad(tcr, t_mb, tc))
        assert_bf16_route(port, j[True], j[False], f"critic H 64, slice {i}")
