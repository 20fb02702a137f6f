"""The port's networks, distribution, transforms and weight files against
the JAX package, with weights carried across by ``from_jax_params``."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.env.types import Observations as JObservations
from marlnav_tpu.models import DiagGaussian as JDiagGaussian
from marlnav_tpu.models import (actor_apply, actor_init, critic_apply,
                                critic_init)
from marlnav_tpu.models.networks import ActorParams, CriticParams, Dense
from marlnav_tpu.utils.stats import load_weights as j_load_weights
from marlnav_tpu.utils.transforms import (make_action_scaler as j_scaler,
                                          make_obs_normalizer as j_normalizer)
from marlnav_tpu_torch.config import NormalizerConfig, ScalerConfig
from marlnav_tpu_torch.env.types import Observations
from marlnav_tpu_torch.models import (Actor, Critic, DiagGaussian,
                                      from_jax_params, to_jax_params)
from marlnav_tpu_torch.utils.stats import StatsLogger, load_weights
from marlnav_tpu_torch.utils.transforms import (make_action_scaler,
                                                make_obs_normalizer)

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs")
# float32 matmuls of width <= 50 summed in another order: ~1e-6 relative.
RTOL, ATOL = 1e-5, 1e-6


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_nets(seed=0, obs=12, hidden=50, agents=3):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return actor_init(k1, obs, hidden, 2), critic_init(k2, obs, agents, hidden)


def test_actor_critic_match_jax():
    j_actor, j_critic = jax_nets()
    actor, critic = from_jax_params((np_tree(j_actor), np_tree(j_critic)))
    obs = np.random.default_rng(1).normal(size=(16, 3, 12)).astype(np.float32)
    mean, var = actor_apply(j_actor, jnp.asarray(obs))
    values = critic_apply(j_critic, jnp.asarray(obs))
    with torch.no_grad():
        t_mean, t_var = actor(torch.from_numpy(obs))
        t_values = critic(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), RTOL, ATOL)
    np.testing.assert_allclose(t_var.numpy(), np.asarray(var), RTOL, ATOL)
    np.testing.assert_allclose(t_values.numpy(), np.asarray(values), RTOL,
                               ATOL)


def test_params_round_trip_and_layout():
    """to_jax_params inverts from_jax_params exactly; nn.Linear holds the
    transpose of the JAX (in, out) weight."""
    j_actor, j_critic = np_tree(jax_nets(3))
    actor, critic = from_jax_params((j_actor, j_critic))
    np.testing.assert_array_equal(actor.fc1.weight.detach().numpy(),
                                  j_actor.fc1.w.T)
    back_a, back_c = to_jax_params(actor, critic)
    for got, want in zip(
            jax.tree.leaves(ActorParams(*(Dense(**back_a[k]) for k in
                                          ("fc1", "fc_mu", "fc_var")))),
            jax.tree.leaves(j_actor)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            jax.tree.leaves(CriticParams(*(Dense(**back_c[k]) for k in
                                           ("fc1", "fc2")))),
            jax.tree.leaves(j_critic)):
        np.testing.assert_array_equal(got, want)


def test_orthogonal_init_and_bias_range():
    g = torch.Generator().manual_seed(3)
    actor = Actor(12, 50, generator=g)
    w = actor.fc1.weight.detach().numpy()  # (50, 12): orthonormal columns
    np.testing.assert_allclose(w.T @ w, np.eye(12), atol=1e-5)
    w2 = actor.fc_mu.weight.detach().numpy()  # (2, 50): orthonormal rows
    np.testing.assert_allclose(w2 @ w2.T, np.eye(2), atol=1e-5)
    assert np.abs(actor.fc1.bias.detach().numpy()).max() <= 1 / np.sqrt(12)
    again = Actor(12, 50, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(again.fc1.weight.detach().numpy(), w)


def test_diag_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(64, 2)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(64, 2)).astype(np.float32)
    x = rng.normal(size=(64, 2)).astype(np.float32)
    jd = JDiagGaussian(jnp.asarray(mean), jnp.asarray(var))
    td = DiagGaussian(torch.from_numpy(mean), torch.from_numpy(var))
    np.testing.assert_allclose(td.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()),
                               rtol=1e-6, atol=1e-6)
    # sample: mean + sqrt(var) * N(0, 1) from the generator.
    d = DiagGaussian(torch.tensor([1.0, -2.0]).expand(20000, 2),
                     torch.tensor([0.25, 4.0]).expand(20000, 2))
    s = d.sample(torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(s.mean(0), [1.0, -2.0], atol=0.05)
    np.testing.assert_allclose(s.std(0), [0.5, 2.0], atol=0.05)


def test_normalizer_and_scaler_match_jax():
    rng = np.random.default_rng(2)
    shapes = [(8, 3, 1), (8, 3, 1), (8, 3, 3), (8, 3, 3), (8, 3, 2),
              (8, 3, 2)]
    parts = [rng.uniform(-3, 1600, size=s).astype(np.float32) for s in shapes]
    want = j_normalizer(JNormalizerConfig())(
        JObservations(*map(jnp.asarray, parts)))
    got = make_obs_normalizer(NormalizerConfig())(
        Observations(*map(torch.from_numpy, parts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    acts = rng.uniform(-1, 1, size=(8, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        make_action_scaler(ScalerConfig())(torch.from_numpy(acts)).numpy(),
        np.asarray(j_scaler(JScalerConfig())(jnp.asarray(acts))),
        rtol=1e-6, atol=1e-6)


def test_trained_snapshot_loads_in_both_packages():
    """A trained actor snapshot from docs/ gives the same policy in both."""
    path = sorted(glob.glob(os.path.join(DOCS,
                                         "curriculum_r5*_actor_stage*.npz")))[0]
    j_actor = j_load_weights(path, actor_init(jax.random.PRNGKey(0), 12, 50))
    actor = load_weights(path, Actor(12, 50))
    obs = np.random.default_rng(4).uniform(-1, 1, size=(32, 3, 12)
                                           ).astype(np.float32)
    mean, var = actor_apply(j_actor, jnp.asarray(obs))
    with torch.no_grad():
        t_mean, t_var = actor(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), RTOL, ATOL)
    np.testing.assert_allclose(t_var.numpy(), np.asarray(var), RTOL, ATOL)
    with pytest.raises(ValueError, match="shape"):
        load_weights(path, Actor(12, 24))


def test_weight_files_interchange(tmp_path):
    """Weights the port writes load in the JAX package and back, exactly."""

    class TS:
        actor = Actor(12, 50, generator=torch.Generator().manual_seed(5))
        critic = Critic(12, 3, 50, generator=torch.Generator().manual_seed(6))

    logger = StatsLogger(root=str(tmp_path), timestamp="t0")
    logger.save_weights(TS)
    j_actor = j_load_weights(str(tmp_path / "weights" / "t0_actor.npz"),
                             actor_init(jax.random.PRNGKey(0), 12, 50))
    j_critic = j_load_weights(str(tmp_path / "weights" / "t0_critic.npz"),
                              critic_init(jax.random.PRNGKey(0), 12, 3, 50))
    np.testing.assert_array_equal(np.asarray(j_actor.fc_var.w),
                                  TS.actor.fc_var.weight.detach().numpy().T)
    back = load_weights(str(tmp_path / "weights" / "t0_critic.npz"),
                        Critic(12, 3, 50))
    for x, y in zip(back.parameters(), TS.critic.parameters()):
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy())
    np.testing.assert_array_equal(np.asarray(j_critic.fc2.b),
                                  TS.critic.fc2.bias.detach().numpy())
