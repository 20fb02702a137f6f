"""The port's scripted samplers and diagnostics modes (-rc, -re,
--save-animation) against the JAX package's, on the CPU.

The samplers are held exactly (the same float32 constants).  Trajectories
of the mock scenarios are held against the JAX package's
``rollout_trajectory`` and against the reference goldens
(tests/goldens/sn{0,1}.npz) at the tolerances of
tests/test_cli_and_io.py:126-146: target angles rtol/atol 1e-5, rewards
rtol 1e-5 / atol 1e-3 over 100 steps; the other fields at those of
tests/test_torch_env.py's golden parity (rtol 2e-5, atol 2e-3: float32
positions grow to ~1e3).  A policy-mean trajectory (tamed weights carried
across by ``from_jax_params``, 20 steps) is held at rtol 1e-4 / atol 1e-3.
Plots and animations are written headless (Agg, Pillow); the paths where
matplotlib is missing are run with its import made to fail.
"""

import builtins
import glob
import os
from typing import NamedTuple

import jax
import matplotlib
import numpy as np
import pytest
import torch

from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MockSamplerConfig as JMockSampler
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import ConstantSamplerConfig as JConstantSampler
from marlnav_tpu.config import mock_init_scenario as j_mock_init_scenario
from marlnav_tpu.diagnostics import check_rews as j_check_rews
from marlnav_tpu.diagnostics import rollout_trajectory as j_rollout
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.env.samplers import make_action_sampler as j_make_sampler
from marlnav_tpu.models import actor_init, critic_init
from marlnav_tpu.utils.stats import StatsLogger as JStatsLogger
from marlnav_tpu_torch.__main__ import build_parser, cli
from marlnav_tpu_torch.config import (ConstantSamplerConfig, EnvParams,
                                      MockSamplerConfig, NormalizerConfig,
                                      ScalerConfig, mock_init_scenario,
                                      resolve_run_config)
from marlnav_tpu_torch.diagnostics import (Animation, check_rews,
                                           init_render, rollout_trajectory)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.env.samplers import make_action_sampler
from marlnav_tpu_torch.models import from_jax_params
from marlnav_tpu_torch.utils.seeding import make_generator

from test_torch_fused_collect import tame_policy

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
OBS_FIELDS = ["target_angle", "target_distance", "obstacles_angles",
              "obstacles_distances", "others_angles", "others_distances"]
TINY = ["--device", "cpu", "-np", "4", "-bl", "20", "-bs", "10", "-ne", "2",
        "-nt", "160", "-se", "3"]

matplotlib.use("Agg")


SAMPLERS = {
    "constant": (ConstantSamplerConfig(num_parallel=2, num_agents=3),
                 JConstantSampler(num_parallel=2, num_agents=3)),
    "mock0": (MockSamplerConfig(num=0, max_step=8),
              JMockSampler(num=0, max_step=8)),
    "mock1": (MockSamplerConfig(num=1, max_step=8),
              JMockSampler(num=1, max_step=8)),
}


@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_samplers_match_jax(kind, step):
    """Each sampler's (P, A, 2) actions at steps 0, 1 and 7, exactly; mock
    1 plays its special actions at step 0 only."""
    cfg, j_cfg = SAMPLERS[kind]
    got = make_action_sampler(cfg, "cpu")(step)
    want = np.asarray(j_make_sampler(j_cfg)(step))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "mock1":  # step 0's special actions, then one constant set
        later = make_action_sampler(cfg, "cpu")(5)
        assert torch.equal(got, later) == (step != 0)


@pytest.mark.parametrize("kind", ["mock0", "mock1"])
def test_mock_samplers_exhaust_as_jax(kind):
    """An int step at or past max_step raises StopIteration, and the bound
    is exported; the constant sampler and None have none."""
    cfg, j_cfg = SAMPLERS[kind]
    sample, j_sample = make_action_sampler(cfg), j_make_sampler(j_cfg)
    assert sample.max_step == j_sample.max_step == 8
    for fn in (sample, j_sample):
        with pytest.raises(StopIteration):
            fn(8)
    assert not hasattr(make_action_sampler(SAMPLERS["constant"][0]),
                       "max_step")
    assert make_action_sampler(None) is None
    with pytest.raises(TypeError):
        make_action_sampler(object())


def _mock_envs(num):
    params = dict(num_parallel=2, num_obstacles=1)
    env = make_env(EnvParams(**params), mock_init_scenario(num), "cpu",
                   sampler_cfg=MockSamplerConfig(num=num))
    j_env = j_make_env(JEnvParams(**params), j_mock_init_scenario(num),
                       JMockSampler(num=num))
    return env, j_env


@pytest.mark.parametrize("num", [0, 1])
def test_mock_trajectory_matches_jax_and_goldens(num):
    """The scripted trajectory of mock scenario 0 and 1 (100 steps, P 2)
    against the JAX package's and the reference goldens."""
    n = 100
    env, j_env = _mock_envs(num)
    traj = rollout_trajectory(env, n, make_generator(0))
    j_traj = j_rollout(j_env, n, jax.random.PRNGKey(0))
    golden = np.load(os.path.join(GOLDENS, f"sn{num}.npz"))
    np.testing.assert_allclose(traj.obs.target_angle,
                               golden["target_angle"][:n], rtol=1e-5,
                               atol=1e-5)
    # Mock 1's agents head nearly straight at the target, where one float32
    # ulp of the dot moves acos by 3.45e-4 rad: the JAX package's own
    # trajectory lies that far from the golden there, the port's within
    # 1e-6; against JAX, tests/test_torch_env.py's angle band (16 ulps).
    np.testing.assert_allclose(traj.obs.target_angle,
                               j_traj.obs.target_angle, rtol=1e-5,
                               atol=1e-5 if num == 0 else 1.5e-3)
    for want in (golden["rewards"][:n], j_traj.rewards):
        np.testing.assert_allclose(traj.rewards, want, rtol=1e-5, atol=1e-3)
    for field in OBS_FIELDS:
        for want in (golden[field][:n], getattr(j_traj.obs, field)):
            np.testing.assert_allclose(getattr(traj.obs, field), want,
                                       rtol=2e-5, atol=2e-3, err_msg=field)
    for name in ("states", "obstacles", "target"):
        np.testing.assert_allclose(getattr(traj, name),
                                   np.asarray(getattr(j_traj, name)),
                                   rtol=2e-5, atol=2e-3, err_msg=name)
    np.testing.assert_allclose(traj.states, golden["states"][:n], rtol=2e-5,
                               atol=2e-3)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(traj, name), golden[name][:n])
        assert getattr(traj, name).dtype == np.bool_


def test_trajectory_rejects_an_overrun_and_a_missing_sampler():
    """num_steps past the sampler's bound raises StopIteration before any
    step; no sampler and no actor raises ValueError."""
    env = make_env(EnvParams(num_parallel=2, num_obstacles=1),
                   mock_init_scenario(0), "cpu",
                   sampler_cfg=MockSamplerConfig(num=0, max_step=5))
    with pytest.raises(StopIteration):
        rollout_trajectory(env, 6, make_generator(0))
    assert rollout_trajectory(env, 5, make_generator(0)).rewards.shape == \
        (5, 2)
    bare = make_env(EnvParams(num_parallel=2, num_obstacles=1),
                    mock_init_scenario(0), "cpu")
    assert bare.sample_actions is None
    with pytest.raises(ValueError, match="no scripted sampler"):
        rollout_trajectory(bare, 3, make_generator(0))


class _TS(NamedTuple):
    actor: object


def test_policy_mean_trajectory_matches_jax():
    """The policy mean from tamed weights carried across, 20 steps under
    mock scenario 1's init: states, observations and rewards."""
    params = dict(num_parallel=2, num_obstacles=1)
    ja = tame_policy(_TS(actor_init(jax.random.PRNGKey(4), 8, 50, 2))).actor
    jc = critic_init(jax.random.PRNGKey(5), 8, 3, 50)
    actor, _ = from_jax_params(jax.tree.map(np.asarray, (ja, jc)))
    env = make_env(EnvParams(**params), mock_init_scenario(1), "cpu")
    j_env = j_make_env(JEnvParams(**params), j_mock_init_scenario(1), None)
    traj = rollout_trajectory(env, 20, make_generator(0), actor=actor,
                              normalizer_cfg=NormalizerConfig(num_obstacles=1),
                              scaler_cfg=ScalerConfig())
    j_traj = j_rollout(j_env, 20, jax.random.PRNGKey(0), actor=ja,
                       normalizer_cfg=JNormalizerConfig(num_obstacles=1),
                       scaler_cfg=JScalerConfig())
    np.testing.assert_allclose(traj.states, np.asarray(j_traj.states),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(traj.rewards, np.asarray(j_traj.rewards),
                               rtol=1e-4, atol=1e-3)
    for field in OBS_FIELDS:
        np.testing.assert_allclose(getattr(traj.obs, field),
                                   np.asarray(getattr(j_traj.obs, field)),
                                   rtol=1e-4, atol=1e-3, err_msg=field)
    # the policy moved the agents otherwise than the scripted sampler does
    scripted = rollout_trajectory(
        make_env(EnvParams(**params), mock_init_scenario(1), "cpu",
                 sampler_cfg=MockSamplerConfig(num=1)), 20, make_generator(0))
    assert not np.allclose(traj.states, scripted.states)


def test_check_rews_matches_jax(tmp_path):
    """check_rews' series against the JAX package's on mock scenario 0,
    and both plot files, the reward one with the reference's 7-placeholder
    name."""
    env, j_env = _mock_envs(0)
    series = check_rews(env, 100, 0, 1, plots_dir=str(tmp_path / "t"))
    want = j_check_rews(j_env, 100, 0, 1, plots_dir=str(tmp_path / "j"))
    assert set(series) == set(want)
    for key in want:
        np.testing.assert_allclose(series[key], want[key], rtol=2e-5,
                                   atol=2e-3, err_msg=key)
    for d in ("t", "j"):
        assert (tmp_path / d / "states_array_0_agent_1.png").exists()
        assert (tmp_path / d /
                "rewards_B0A1T500.0H500.0D0.0R0.0S500.0.png").exists()


def test_reward_check_mode(tmp_path, monkeypatch):
    """-rc -sn 0 through cli: the series returned, the plots written."""
    monkeypatch.chdir(tmp_path)
    series = cli(["--device", "cpu", "-rc", "-sn", "0", "-ms", "30"])
    assert series["rewards"].shape == (30,)
    assert (tmp_path / "plots" / "states_array_0_agent_0.png").exists()
    assert (tmp_path / "plots" /
            "rewards_B0A0T500.0H500.0D0.0R0.0S500.0.png").exists()


def test_rendering_headless(tmp_path, monkeypatch):
    """-re -sn 1 --save-animation writes a non-empty GIF and returns the
    Animation."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "anim.gif")
    anim = cli(["--device", "cpu", "-re", "-sn", "1", "-ms", "10",
                "--save-animation", out])
    assert isinstance(anim, Animation)
    assert os.path.getsize(out) > 0


def test_rendering_window_path(tmp_path, monkeypatch):
    """run() without a save path builds the FuncAnimation and calls
    plt.show() (a no-op under Agg), and update() moves the artists
    (tests/test_cli_and_io.py:233-261)."""
    monkeypatch.chdir(tmp_path)
    cfg = resolve_run_config(build_parser().parse_args(
        ["-re", "-sn", "1", "-ms", "8"]))
    env = make_env(cfg.env, cfg.init, "cpu", sampler_cfg=cfg.sampler)
    renderer = init_render(env, cfg.animation, normalizer_cfg=cfg.normalizer,
                           scaler_cfg=cfg.scaler,
                           hidden_size=cfg.animation.hidden_size,
                           generator=make_generator(3))
    first = np.array(renderer.agents_scatter.get_offsets(), copy=True)
    assert renderer.run(show=True, save_path=None) is not None
    assert len(renderer.update(5)) > 0
    assert not np.allclose(first, np.array(
        renderer.agents_scatter.get_offsets()))


def _jax_weights(tmp_path, hidden):
    """An actor weight file written by the JAX package's logger."""
    ja = actor_init(jax.random.PRNGKey(2), 12, hidden, 2)
    jc = critic_init(jax.random.PRNGKey(3), 12, 3, hidden)
    logger = JStatsLogger(root=str(tmp_path), timestamp="jax")
    logger.save_weights(NamedTupleTS(ja, jc))
    return "jax_actor.npz"


class NamedTupleTS(NamedTuple):
    actor: object
    critic: object


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_policy_rendering_from_weights(tmp_path, monkeypatch, writer):
    """-re -sa policy -hs 24 from weights the port's trainer wrote and from
    weights the JAX package's logger wrote, each resolved under
    ./weights."""
    monkeypatch.chdir(tmp_path)
    if writer == "port":
        cli(TINY + ["-hs", "24"])
        weights = os.path.basename(
            glob.glob(str(tmp_path / "weights" / "*_actor.npz"))[0])
    else:
        weights = _jax_weights(tmp_path, 24)
    out = str(tmp_path / "anim_policy.gif")
    anim = cli(["--device", "cpu", "-re", "-sa", "policy", "-hs", "24", "-w",
                weights, "-np", "2", "-ms", "8", "--save-animation", out])
    assert os.path.getsize(out) > 0
    assert anim.traj.states.shape == (8, 2, 3, 5)


def test_reward_check_rejects_policy():
    with pytest.raises(SystemExit):
        cli(["--device", "cpu", "-rc", "-sa", "policy"])


def _without_matplotlib(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)


@pytest.mark.parametrize("mode", ["reward_check", "rendering"])
def test_without_matplotlib(tmp_path, monkeypatch, capsys, mode):
    """Where matplotlib cannot be imported, -rc prints a note, writes no
    plot and returns its series; -re raises an error naming matplotlib and
    writes no file."""
    monkeypatch.chdir(tmp_path)
    _without_matplotlib(monkeypatch)
    if mode == "reward_check":
        series = cli(["--device", "cpu", "-rc", "-sn", "0", "-ms", "20"])
        assert series["rewards"].shape == (20,)
        assert "matplotlib is not installed" in capsys.readouterr().out
        assert not (tmp_path / "plots").exists()
    else:
        out = tmp_path / "x.gif"
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            cli(["--device", "cpu", "-re", "-sn", "1", "-ms", "5",
                 "--save-animation", str(out)])
        assert not out.exists()
