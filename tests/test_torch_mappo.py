"""The port's MAPPO math against the JAX package: returns, losses and
their gradients, the clip-edge gradient rule, Adam against optax, and a
whole 2-epoch update phase.  Inputs are numpy-seeded and handed to both.

Clip edges: JAX's ``jnp.clip`` passes half the gradient at an exact bound
(``minimum(maximum(x, lo), hi)`` splits the tie); ``torch.clamp`` passes
all of it.  The port's ``algo.mappo.clip`` is written the JAX way, and
``test_clip_edge_gradient_matches_jax`` pins that at exact bounds.  The
random buffers of the other tests never land exactly on a bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marlnav_tpu.algo import Buffer as JBuffer
from marlnav_tpu.algo import make_mappo as j_make_mappo
from marlnav_tpu.algo import mappo as jm
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.models import actor_init, critic_init
from marlnav_tpu_torch.algo import mappo as tm
from marlnav_tpu_torch.algo.mappo import Buffer, TrainState, make_mappo
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import from_jax_params
from marlnav_tpu_torch.utils.seeding import make_generator

T, P, A, OBS, H = 12, 4, 3, 12, 16
MODES = {"faithful": dict(), "fixed": dict(faithful=False),
         "gae": dict(faithful=False, use_gae=True)}


def cfgs(**kw):
    base = dict(num_agents=A, num_parallel=P, obs_size=OBS, hidden_size=H,
                num_total=T * P, buffer_len=T, num_epochs=2, batch_size=T)
    base.update(kw)
    return JMAPPOConfig(**base), MAPPOConfig(**base)


def rand_buffer(seed, mode="faithful"):
    """A numpy buffer; in GAE mode its returns are GAE advantages + values,
    as collect stores them."""
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(T, P, A, OBS)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(T, P, A, 2)).astype(np.float32),
        log_probs=rng.normal(-1.0, 0.5, size=(T, P * A)).astype(np.float32),
        values=rng.normal(size=(T, P, 1)).astype(np.float32),
        returns=rng.normal(size=(T, P)).astype(np.float32),
        done=rng.uniform(size=(T, P)) < 0.2)
    if mode == "gae":
        adv = jm.gae_advantages(jnp.asarray(b["returns"]),
                                jnp.asarray(b["done"]),
                                jnp.asarray(b["values"][..., 0]),
                                jnp.zeros(P), 0.9, 0.95)
        b["returns"] = np.asarray(adv) + b["values"][..., 0]
    return (JBuffer(**{k: jnp.asarray(v) for k, v in b.items()}),
            Buffer(**{k: torch.tensor(v) for k, v in b.items()}))


def nets(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ja, jc = actor_init(k1, OBS, H, 2), critic_init(k2, OBS, A, H)
    ta, tc = from_jax_params(jax.tree.map(np.asarray, (ja, jc)))
    return ja, jc, ta, tc


def grads_as_jax_layout(module):
    """{"fc1.w": (in, out), ...} numpy gradients of an nn.Module."""
    return {f"{name}.{leaf}": (p.grad.numpy().T if leaf == "w"
                               else p.grad.numpy())
            for name, layer in module.named_children()
            for leaf, p in (("w", layer.weight), ("b", layer.bias))}


def jax_flat(tree):
    return {f"{name}.{leaf}": np.asarray(getattr(dense, leaf))
            for name, dense in tree._asdict().items() for leaf in ("w", "b")}


def test_returns_match_jax():
    rng = np.random.default_rng(0)
    rewards = rng.normal(scale=100.0, size=(T, P)).astype(np.float32)
    done = rng.uniform(size=(T, P)) < 0.3
    values = rng.normal(size=(T, P)).astype(np.float32)
    last = rng.normal(size=P).astype(np.float32)
    jc, tc = cfgs()
    r_j, r_t = jnp.asarray(rewards), torch.tensor(rewards)
    d_j, d_t = jnp.asarray(done), torch.tensor(done)
    # The same sequential recursion in float32: equal to rounding.
    np.testing.assert_allclose(
        tm.discounted_returns(r_t, d_t, 0.9).numpy(),
        np.asarray(jm.discounted_returns(r_j, d_j, 0.9)), rtol=1e-6,
        atol=1e-4)
    n_j, m_j = jm.reference_returns(r_j, d_j, jc)
    n_t, m_t = tm.reference_returns(r_t, d_t, tc)
    # Buffer-wide mean and unbiased std reduce in another order.
    np.testing.assert_allclose(float(m_t), float(m_j), rtol=1e-5)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tm.gae_advantages(r_t, d_t, torch.tensor(values), torch.tensor(last),
                          0.9, 0.95).numpy(),
        np.asarray(jm.gae_advantages(r_j, d_j, jnp.asarray(values),
                                     jnp.asarray(last), 0.9, 0.95)),
        rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_losses_and_grads_match_jax(mode):
    """Loss values and autograd gradients against jax.value_and_grad on one
    buffer.  float32 sums over T*P*A rows in another order: 1e-5 relative
    on the losses, 1e-4 relative + 1e-6 absolute on the gradients."""
    jc, tc = cfgs(**MODES[mode])
    jb, tb = rand_buffer(1, mode)
    ja, jcr, ta, tcr = nets(2)
    for j_loss, t_loss, j_params, t_module in (
            (jm.actor_loss, tm.actor_loss, ja, ta),
            (jm.critic_loss, tm.critic_loss, jcr, tcr)):
        lj, gj = jax.value_and_grad(j_loss)(j_params, jb, jc)
        lt = t_loss(t_module, tb, tc)
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5,
                                   err_msg=t_loss.__name__)
        got, want = grads_as_jax_layout(t_module), jax_flat(gj)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=f"{t_loss.__name__} {key}")
    # The two pairings genuinely differ (tile vs repeat-interleave).
    with torch.no_grad():
        l_fixed = float(tm.actor_loss(ta, tb, cfgs(faithful=False)[1]))
        l_faith = float(tm.actor_loss(ta, tb, cfgs()[1]))
    assert l_fixed != pytest.approx(l_faith)


def test_clip_edge_gradient_matches_jax():
    """At an exact clip bound JAX passes half the gradient; the port's clip
    does too (torch.clamp would pass all of it)."""
    x = np.array([0.5, 0.99, 1.0, 1.01, 1.5], np.float32)
    lo, hi = np.float32(0.99), np.float32(1.01)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi)))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    tm.clip(xt, lo, hi).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])
    # Tensor bounds (the critic's values +- epsilon) follow the same rule.
    xt.grad = None
    tm.clip(xt, torch.full((5,), 0.99), torch.full((5,), 1.01)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_adam_steps_match_optax():
    """torch.optim.Adam with the port's settings equals optax.adam step for
    step (same betas and eps; the bias corrections are applied in another
    order: 1e-6 relative)."""
    ja, _, ta, _ = nets(4)
    opt = torch.optim.Adam(ta.parameters(), lr=1e-3)
    tx = optax.adam(1e-3)
    state = tx.init(ja)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), ja)
        upd, state = tx.update(g, state, ja)
        ja = optax.apply_updates(ja, upd)
        flat = jax_flat(g)
        for name, layer in ta.named_children():
            layer.weight.grad = torch.tensor(flat[f"{name}.w"].T.copy())
            layer.bias.grad = torch.tensor(flat[f"{name}.b"])
        opt.step()
    got = {f"{name}.{leaf}": (p.detach().numpy().T if leaf == "w"
                              else p.detach().numpy())
           for name, layer in ta.named_children()
           for leaf, p in (("w", layer.weight), ("b", layer.bias))}
    for key, want in jax_flat(ja).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_minibatch_slices():
    """faithful: the batch reaching the buffer end drops the final step
    (reference models.py:167-171); fixed: full batches."""
    _, tb = rand_buffer(4)
    shapes = lambda **kw: [s.obs.shape[0] for s in  # noqa: E731
                           tm.minibatch_slices(tb, cfgs(**kw)[1])]
    assert shapes() == [T - 1]
    assert shapes(faithful=False) == [T]
    assert shapes(batch_size=T // 2) == [T // 2, T // 2 - 1]
    assert shapes(batch_size=T // 2, faithful=False) == [T // 2, T // 2]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_epoch_phases_match_jax(mode):
    """A whole actor phase and critic phase (2 epochs x 2 minibatches, with
    the faithful last-step drop) from the same weights on the same buffer:
    losses and trained parameters match.  Tolerance: the per-step ulp
    differences of the gradients pass through 4 Adam steps (each moving a
    parameter by ~lr = 1e-3): 1e-4 relative, 1e-5 absolute."""
    jc, tc = cfgs(batch_size=T // 2, **MODES[mode])
    jb, tb = rand_buffer(6, mode)
    ja, jcr, ta, tcr = nets(7)
    j_env = j_make_env(JEnvParams(num_parallel=P), JTriangleInit(
        num_parallel=P), None)
    j_mappo = j_make_mappo(jc, j_env, JNormalizerConfig(), JScalerConfig())
    j_ts = jm.TrainState(ja, jcr, optax.adam(jc.lr).init(ja),
                         optax.adam(jc.lr).init(jcr))
    j_ts, j_al = jax.jit(j_mappo.train_actor)(j_ts, jb)
    j_ts, j_cl = jax.jit(j_mappo.train_critic)(j_ts, jb)

    t_env = make_env(EnvParams(num_parallel=P), TriangleInitConfig(
        num_parallel=P), "cpu")
    t_mappo = make_mappo(tc, t_env, NormalizerConfig(), ScalerConfig())
    t_ts = TrainState(ta, tcr, torch.optim.Adam(ta.parameters(), lr=tc.lr),
                      torch.optim.Adam(tcr.parameters(), lr=tc.lr))
    t_ts, t_al = t_mappo.train_actor(t_ts, tb)
    t_ts, t_cl = t_mappo.train_critic(t_ts, tb)

    assert t_al.shape == (jc.num_epochs * jc.num_minibatches,)
    np.testing.assert_allclose(t_al.numpy(), np.asarray(j_al), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_cl.numpy(), np.asarray(j_cl), rtol=1e-4,
                               atol=1e-5)
    for t_mod, j_params in ((t_ts.actor, j_ts.actor),
                            (t_ts.critic, j_ts.critic)):
        got = {f"{n}.{leaf}": (p.detach().numpy().T if leaf == "w"
                               else p.detach().numpy())
               for n, layer in t_mod.named_children()
               for leaf, p in (("w", layer.weight), ("b", layer.bias))}
        for key, want in jax_flat(j_params).items():
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_full_repeat_trains(mode):
    """collect -> train_actor -> train_critic through the port's plain
    rollout loop: shapes, finite losses, normalized returns, moving
    parameters."""
    _, tc = cfgs(**MODES[mode])
    env = make_env(EnvParams(num_parallel=P, episode_len=8),
                   TriangleInitConfig(num_parallel=P), "cpu")
    mappo = make_mappo(tc, env, NormalizerConfig(), ScalerConfig())
    g = make_generator(3)
    ts, es = mappo.init(g)
    w0 = ts.actor.fc1.weight.detach().clone()
    es, buf, metrics = mappo.collect(ts, es, g)
    assert buf.obs.shape == (T, P, A, OBS)
    assert buf.log_probs.shape == (T, P * A) and buf.values.shape == (T, P, 1)
    assert buf.done.dtype == torch.bool and buf.done[7].all()  # truncation
    assert int(metrics.stats.num_trunc) == P
    if not tc.use_gae:
        assert abs(float(buf.returns.mean())) < 1e-5
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    assert torch.isfinite(al).all() and torch.isfinite(cl).all()
    assert not torch.equal(w0, ts.actor.fc1.weight.detach())


def test_unported_mappo_options_raise():
    """bf16_updates, the last MAPPOConfig option the port lacked, builds
    now; the CLI's tensor-parallel flag is ported too
    (tests/test_torch_tensor_parallel.py), so only --allow-interpret, which
    has no counterpart, raises before any config is built (--num-data and
    --multihost: tests/test_torch_data_parallel.py)."""
    from marlnav_tpu_torch.__main__ import build_parser, reject_unported

    env = make_env(EnvParams(num_parallel=P), TriangleInitConfig(
        num_parallel=P), "cpu")
    cfg = dataclasses.replace(cfgs()[1], bf16_updates=True)
    make_mappo(cfg, env, NormalizerConfig(), ScalerConfig())
    reject_unported(build_parser().parse_args(["--bf16-updates"]))
    reject_unported(build_parser().parse_args(["--num-model", "2"]))
    with pytest.raises(NotImplementedError, match="no counterpart"):
        reject_unported(build_parser().parse_args(["--allow-interpret"]))
