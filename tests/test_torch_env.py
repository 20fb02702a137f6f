"""The PyTorch port's environment against the reference goldens and
against ``marlnav_tpu.env`` step for step.

Inputs are made with numpy and handed to both packages.  Reset draws come
from different generators in the two packages (jax.random vs torch), so
fields that depend on a fresh draw are compared only where no env
finished; everything else is compared everywhere.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.config import ConstantSamplerConfig as JConstantSampler
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MockSamplerConfig as JMockSampler
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.env.samplers import make_action_sampler
from marlnav_tpu.env.types import EnvState as JEnvState
from marlnav_tpu.env.types import EpisodeStats as JEpisodeStats
from marlnav_tpu_torch.config import (EnvParams, MockInitConfig,
                                      TriangleInitConfig, mock_init_scenario)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.utils.seeding import make_generator

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
OBS_FIELDS = ["target_angle", "target_distance", "obstacles_angles",
              "obstacles_distances", "others_angles", "others_distances"]


def _tri_fix_init() -> MockInitConfig:
    """The fixed triangle scenario of tests/make_goldens.py golden_tri_fix."""
    pos_const = 0.5 * 40.0
    r3 = math.sqrt(3.0)
    base = [[-1 / r3, 1.0], [2 / r3, 0.0], [-1 / r3, -1.0]]
    agents = tuple((150.0 + pos_const * bx, 375.0 + pos_const * by, 1.0, 0.0,
                    3.0) for bx, by in base)
    return MockInitConfig(
        states=(agents, agents),
        obstacles=(((700.0, 375.0), (600.0, 100.0), (900.0, 600.0)),
                   ((700.0, 100.0), (600.0, 650.0), (900.0, 625.0))),
        target=(((1350.0, 375.0),), ((1350.0, 375.0),)),
    )


# The scripted actions come from the JAX package's samplers (the port's
# slice has no samplers); they are fixed inputs, not policy outputs.
CASES = {
    "sn0": (lambda: mock_init_scenario(0), JMockSampler(num=0), 1, 400),
    "sn1": (lambda: mock_init_scenario(1), JMockSampler(num=1), 1, 400),
    "tri_fix": (_tri_fix_init, JConstantSampler(num_parallel=2, num_agents=3),
                3, 300),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_parity(name):
    """Same fixtures and tolerances as tests/test_env_parity.py."""
    init, sampler_cfg, num_obstacles, steps = CASES[name]
    golden = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    env = make_env(EnvParams(num_parallel=2, num_obstacles=num_obstacles),
                   init(), "cpu")
    sampler = make_action_sampler(sampler_cfg)
    state = env.init(make_generator(0))
    obs, rew, term, trunc, states = [], [], [], [], []
    for t in range(steps):
        actions = torch.tensor(np.asarray(sampler(t), np.float32))
        state, out = env.step(state, actions)
        obs.append([getattr(out.obs, f).numpy() for f in OBS_FIELDS])
        rew.append(out.rewards.numpy())
        term.append(out.terminated.numpy())
        trunc.append(out.truncated.numpy())
        states.append(state.states.numpy())

    np.testing.assert_array_equal(np.stack(term), golden["terminated"])
    np.testing.assert_array_equal(np.stack(trunc), golden["truncated"])
    # float32 positions grow to ~1e3: tight absolute + relative tolerance.
    for i, field in enumerate(OBS_FIELDS):
        np.testing.assert_allclose(np.stack([o[i] for o in obs]),
                                   golden[field], rtol=2e-5, atol=2e-3,
                                   err_msg=f"{name}:{field}")
    np.testing.assert_allclose(np.stack(states), golden["states"], rtol=2e-5,
                               atol=2e-3, err_msg=f"{name}:states")
    np.testing.assert_allclose(np.stack(rew), golden["rewards"], rtol=2e-5,
                               atol=2e-3, err_msg=f"{name}:rewards")
    assert int(state.stats.num_trunc) == int(golden["num_trunc"])
    assert int(state.stats.num_col) == int(golden["num_col"])
    assert int(state.stats.num_tar) == int(golden["num_tar"])


P, A, O = 64, 3, 3
# View angles are ill-conditioned where the point is straight ahead
# (dot ~ 1): k float32 ulps of the dot below 1 are an angle of
# acos(1 - k * 6e-8) = 3.45e-4 * sqrt(k) rad, so last-ulp differences in
# the dot between the two frameworks move such an angle by that much.  The
# tolerance admits k <= 16, the band tests/test_fused_collect.py allows
# (5e-4 in pi-normalized units).
ANGLE_ATOL = 1.5e-3


def random_state(rng, episode_len):
    """A numpy env state spread over the arena, with some envs about to
    truncate and some with the target latch set."""
    ang = rng.uniform(-np.pi, np.pi, size=(P, A))
    states = np.concatenate([
        rng.uniform([0, 0], [1500, 750], size=(P, A, 2)),
        np.stack([np.cos(ang), np.sin(ang)], -1),
        rng.uniform(3.0, 10.0, size=(P, A, 1))], axis=2).astype(np.float32)
    # Cluster some agents near each other, the obstacles and the target so
    # every reward and collision term fires somewhere.
    states[: P // 4, :, :2] = (np.array([700.0, 375.0])
                               + rng.normal(scale=25.0, size=(P // 4, A, 2)))
    obstacles = rng.uniform([500, 250], [1000, 500],
                            size=(P, O, 2)).astype(np.float32)
    target = np.broadcast_to(np.array([1350.0, 375.0], np.float32),
                             (P, 1, 2)).copy()
    states[P // 4: P // 2, :, :2] = (target[0] + rng.normal(
        scale=15.0, size=(P // 4, A, 2)))
    step_num = rng.integers(0, episode_len, size=P).astype(np.int32)
    latch = rng.uniform(size=P) < 0.2
    return states.astype(np.float32), obstacles, target, step_num, latch


def both_states(arrays):
    states, obstacles, target, step_num, latch = arrays
    j = JEnvState(jnp.asarray(states), jnp.asarray(obstacles),
                  jnp.asarray(target), jnp.asarray(step_num),
                  jnp.asarray(latch), JEpisodeStats.zeros(),
                  jax.random.PRNGKey(1))
    t = EnvState(*(torch.tensor(x) for x in arrays[:5]),
                 EpisodeStats.zeros("cpu"), make_generator(1))
    return j, t


def envs(episode_len=200):
    j_env = j_make_env(JEnvParams(num_parallel=P, episode_len=episode_len),
                       JTriangleInit(num_parallel=P), None)
    t_env = make_env(EnvParams(num_parallel=P, episode_len=episode_len),
                     TriangleInitConfig(num_parallel=P), "cpu")
    return j_env, t_env


def test_single_step_parity():
    """One step from random states and actions.  Tolerances: float32 with
    different arccos/cos/sin implementations in the two frameworks
    (last-ulp differences on positions ~1e3)."""
    rng = np.random.default_rng(0)
    j_env, t_env = envs()
    js, ts = both_states(random_state(rng, 200))
    actions = np.concatenate([rng.uniform(-4.0, 4.0, size=(P, A, 1)),
                              rng.uniform(-1.0, 1.0, size=(P, A, 1))],
                             axis=2).astype(np.float32)
    js2, jout = jax.jit(j_env.step)(js, jnp.asarray(actions))
    ts2, tout = t_env.step(ts, torch.from_numpy(actions))

    np.testing.assert_array_equal(tout.terminated.numpy(),
                                  np.asarray(jout.terminated))
    np.testing.assert_array_equal(tout.truncated.numpy(),
                                  np.asarray(jout.truncated))
    finished = np.asarray(jout.terminated | jout.truncated)
    assert finished.any() and not finished.all()  # premise: both branches
    np.testing.assert_allclose(tout.rewards.numpy(), np.asarray(jout.rewards),
                               rtol=1e-5, atol=1e-3)
    for name in ("num_trunc", "num_col", "num_tar"):
        assert int(getattr(ts2.stats, name)) == int(getattr(js2.stats, name))
    np.testing.assert_array_equal(ts2.step_num.numpy(),
                                  np.asarray(js2.step_num))
    np.testing.assert_array_equal(ts2.terminates.numpy(),
                                  np.asarray(js2.terminates))
    # Agents and target: everywhere (the triangle reset is deterministic
    # without noisy_ags); obstacles and the returned obs: where no fresh
    # draw entered.
    np.testing.assert_allclose(ts2.states.numpy(), np.asarray(js2.states),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ts2.target.numpy(), np.asarray(js2.target))
    keep = ~finished
    np.testing.assert_array_equal(ts2.obstacles.numpy()[keep],
                                  np.asarray(js2.obstacles)[keep])
    for f in OBS_FIELDS:
        np.testing.assert_allclose(getattr(tout.obs, f).numpy()[keep],
                                   np.asarray(getattr(jout.obs, f))[keep],
                                   rtol=1e-5, atol=ANGLE_ATOL, err_msg=f)


@pytest.mark.parametrize("group_soft", [0.0, 700.0], ids=["plain", "group"])
def test_multi_step_parity_no_reset(group_soft):
    """20 steps of small numpy actions from the triangle start: no env
    finishes, so no reset draw is consumed and the whole state and every
    output must match.  Actions are inputs, not policy outputs, so
    differences cannot feed back; tolerances as in the single step."""
    rng = np.random.default_rng(1)
    t_steps = 20
    ep_j = JEnvParams(num_parallel=P, group_soft_factor=group_soft)
    ep_t = EnvParams(num_parallel=P, group_soft_factor=group_soft)
    j_env = j_make_env(ep_j, JTriangleInit(num_parallel=P), None)
    t_env = make_env(ep_t, TriangleInitConfig(num_parallel=P), "cpu")
    s0 = j_env.init(jax.random.PRNGKey(0))
    js, ts = both_states((np.asarray(s0.states), np.asarray(s0.obstacles),
                          np.asarray(s0.target), np.asarray(s0.step_num),
                          np.asarray(s0.terminates)))
    actions = np.concatenate([
        rng.uniform(-0.05, 0.05, size=(t_steps, P, A, 1)),
        rng.uniform(-0.5, 0.5, size=(t_steps, P, A, 1))], axis=3
    ).astype(np.float32)
    j_step = jax.jit(j_env.step)
    for t in range(t_steps):
        js, jout = j_step(js, jnp.asarray(actions[t]))
        ts, tout = t_env.step(ts, torch.from_numpy(actions[t]))
        assert not np.asarray(jout.terminated | jout.truncated).any()
        np.testing.assert_array_equal(tout.terminated.numpy(),
                                      np.asarray(jout.terminated))
        np.testing.assert_allclose(tout.rewards.numpy(),
                                   np.asarray(jout.rewards),
                                   rtol=1e-5, atol=1e-3, err_msg=f"t={t}")
        for f in OBS_FIELDS:
            np.testing.assert_allclose(getattr(tout.obs, f).numpy(),
                                       np.asarray(getattr(jout.obs, f)),
                                       rtol=1e-5, atol=ANGLE_ATOL,
                                       err_msg=f"t={t} {f}")
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states),
                               rtol=1e-5, atol=1e-3)


def test_noisy_and_staggered_init():
    """The initializer's distributions: noisy triangle positions and
    headings, obstacles inside their rectangle, staggered step phases."""
    n = 4096
    icfg = TriangleInitConfig(num_parallel=n, noisy_ags=True)
    env = make_env(EnvParams(num_parallel=n, staggered_resets=True,
                             episode_len=200), icfg, "cpu")
    s = env.init(make_generator(3))
    st, ob = s.states.numpy(), s.obstacles.numpy()
    assert (ob[..., 0] >= icfg.obst_min_x).all()
    assert (ob[..., 0] <= icfg.obst_max_x).all()
    assert (ob[..., 1] >= icfg.obst_min_y).all()
    assert (ob[..., 1] <= icfg.obst_max_y).all()
    pos_std = icfg.ags_dist * math.sqrt(icfg.ags_std)
    np.testing.assert_allclose(st[:, 1, 0].std(), pos_std, rtol=0.05)
    heading = np.arctan2(st[..., 3], st[..., 2])
    assert np.abs(heading).max() <= icfg.angle_range / 2 + 1e-6
    np.testing.assert_allclose(np.hypot(st[..., 2], st[..., 3]), 1.0,
                               atol=1e-6)
    sn = s.step_num.numpy()
    assert sn.min() >= 0 and sn.max() < 200 and len(np.unique(sn)) > 150


def test_make_env_defaults_to_cuda(monkeypatch):
    """``make_env``'s device defaults to CUDA, as every entry point's does:
    without a card and without a device it raises instead of running on
    the CPU; ``device="cpu"`` still builds a CPU env."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ep, ic = EnvParams(num_parallel=2), TriangleInitConfig(num_parallel=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env(ep, ic)
    assert make_env(ep, ic, "cpu").device == torch.device("cpu")
