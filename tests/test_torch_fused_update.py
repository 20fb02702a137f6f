"""The port's fused-update gradients against the JAX package's Pallas
update kernels (interpret mode) and against the port's own autograd.

The plain versions of ``marlnav_tpu_torch/ops/update_math.py`` are what the
CUDA kernels of ``ops/csrc/fused_update.cu`` compute; on the CPU the
wrappers run them.  Held here against:

* the JAX chains ``_ppo_chain`` / ``_critic_chain`` at exact ties and clip
  edges (the tie rule decides between a gradient and half of it, so a fault
  shows as a factor of 2; the rows built to sit exactly on an edge agree to
  rtol 1e-6, the random rows to rtol 2e-5 / atol 1e-6: last-ulp
  differences of tanh, exp and log between the frameworks);
* the staged kernels (``make_fused_actor_grad`` affine layout and
  ``make_fused_critic_grad``, rows 5 and 4 of the PERF.md table) on every
  minibatch slice: rtol 2e-5 / atol 2e-5, the tolerance of
  tests/test_fused_update.py;
* the tiled trainers (``make_tiled_actor_trainer`` /
  ``make_tiled_critic_trainer``, rows 2 and 3) over 3 epochs of Adam:
  rtol 1e-4 / atol 1e-5, the tolerance of tests/test_fused_update_tiled.py;
* the port's autograd losses in the faithful, fixed and GAE modes:
  rtol 1e-4 / atol 1e-6 (sums over rows in another order).

The un-collapsed actor gradient (``actor_grad_uncollapsed``, through the
network itself) is held against the "packed" and "undilated" staged
kernels (rows 6 and 7) on every slice at rtol/atol 2e-5 and against
autograd at rtol 1e-4 / atol 1e-6; never against the affine kernel, whose
composed operator rounds differently from two chained products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
from marlnav_tpu.models import actor_init, critic_apply, critic_init
from marlnav_tpu.ops.fused_update import (
    _critic_chain,
    _ppo_chain,
    make_fused_actor_grad,
    make_fused_critic_grad,
    stage_actor_minibatch,
    stage_critic_minibatch,
)
from marlnav_tpu.ops.fused_update_tiled import (
    TiledRollout,
    make_tiled_actor_trainer,
    make_tiled_critic_trainer,
)
from marlnav_tpu.ops.step_math import BLOCK_ENVS, LANE, SUB
from marlnav_tpu_torch.algo import mappo as tm
from marlnav_tpu_torch.algo.mappo import Buffer, TrainState, make_mappo
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, from_jax_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import update_math as um

A, OBS, H = 3, 12, 16
MODES = {"faithful": dict(), "fixed": dict(faithful=False),
         "gae": dict(faithful=False, use_gae=True)}
LOG_2PI = float(np.log(2.0 * np.pi))


def cfgs(p, t, **kw):
    base = dict(num_agents=A, num_parallel=p, obs_size=OBS, hidden_size=H,
                num_total=t * p, buffer_len=t, num_epochs=2, batch_size=t)
    base.update(kw)
    return JMAPPOConfig(**base), MAPPOConfig(**base)


def rand_buffer(seed, t, p, mode="faithful", done_frac=0.2, obs=OBS):
    """One numpy buffer handed to both packages; in GAE mode its returns
    are GAE advantages + values, as collect stores them."""
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(t, p, A, obs)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(t, p, A, 2)).astype(np.float32),
        log_probs=rng.normal(-1.0, 0.5, size=(t, p * A)).astype(np.float32),
        values=rng.normal(size=(t, p, 1)).astype(np.float32),
        returns=rng.normal(size=(t, p)).astype(np.float32),
        done=rng.uniform(size=(t, p)) < done_frac)
    if mode == "gae":
        adv = tm.gae_advantages(
            torch.tensor(b["returns"]), torch.tensor(b["done"]),
            torch.tensor(b["values"][..., 0]), torch.zeros(p), 0.9, 0.95)
        b["returns"] = adv.numpy() + b["values"][..., 0]
    return (JBuffer(**{k: jnp.asarray(v) for k, v in b.items()}),
            Buffer(**{k: torch.tensor(v) for k, v in b.items()}))


def jax_flat(tree):
    return {f"{name}.{leaf}": np.asarray(getattr(dense, leaf))
            for name, dense in tree._asdict().items() for leaf in ("w", "b")}


def as_jax_layout(grads):
    """{"fc1.weight": (out, in), ...} -> {"fc1.w": (in, out), ...}."""
    return {k.replace(".weight", ".w").replace(".bias", ".b"):
            (g.numpy().T if k.endswith("weight") else g.numpy())
            for k, g in grads.items()}


def module_flat(module):
    return as_jax_layout({k: p.detach() for k, p in
                          module.named_parameters()})


def assert_grads_close(got, want, rtol, atol, what=""):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {key}")


# ----------------------------------------------------------------------
# The elementwise chains at exact ties and clip edges
# ----------------------------------------------------------------------

@pytest.mark.parametrize("edge", ["lo", "hi"])
def test_ppo_chain_matches_jax_at_ties_and_edges(edge):
    """Rows with u = s = 0 (s exactly 0: softplus's where-branch) and fixed
    actions have a log-prob of plain float32 arithmetic, lp0, computed
    alike by both frameworks (asserted).  Behaviour log-probs lp0 and lp0 ±
    2^-7 then give ratios exactly 1 (inside the band: o1 == o2 ties) and
    exp(±2^-7), and epsilon is chosen so that one of those lies exactly on
    the clip bound under test.  Advantages of both signs and exactly 0."""
    # lp0 in both frameworks, op for op as in the chains.
    act0 = np.array([0.5, -0.25], np.float32)
    lp0 = []
    for xp in (jnp, torch):
        arr = jnp.asarray if xp is jnp else torch.tensor
        s = arr(np.zeros(2, np.float32))
        var = xp.maximum(s, arr(np.float32(0.0))) + xp.log1p(xp.exp(-xp.abs(s)))
        diff = arr(act0) - xp.tanh(s)
        zz = diff * diff * (1.0 / var)
        log_var = xp.log(var)
        lv_sum = log_var[0] + log_var[1]
        lp0.append(np.float32(-0.5 * (2.0 * LOG_2PI + lv_sum + zz[0] + zz[1])))
    assert lp0[0] == lp0[1] and 1.0 <= -lp0[0] < 2.0
    lp0 = lp0[0]
    step = np.float32(2.0 ** -7)
    r_up = [np.float32(jnp.exp(jnp.float32(step))),
            np.float32(torch.exp(torch.tensor(step)))]
    r_dn = [np.float32(jnp.exp(-jnp.float32(step))),
            np.float32(torch.exp(-torch.tensor(step)))]
    assert r_up[0] == r_up[1] and r_dn[0] == r_dn[1]
    eps = (float(r_up[0]) - 1.0) if edge == "hi" else (1.0 - float(r_dn[0]))
    assert np.float32(1.0 + eps if edge == "hi" else 1.0 - eps) == (
        r_up[0] if edge == "hi" else r_dn[0])

    rng = np.random.default_rng(0)
    n_rand = 64
    u = rng.normal(size=(n_rand, 2)).astype(np.float32)
    s = rng.normal(size=(n_rand, 2)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(n_rand, 2)).astype(np.float32)
    lp_b = rng.normal(-1.0, 0.5, size=n_rand).astype(np.float32)
    adv = rng.normal(size=n_rand).astype(np.float32)
    # ratio 1 (x = 0), exp(+2^-7) (lp_b = lp0 - 2^-7), exp(-2^-7); all
    # differences exact in float32.
    special_lp = np.array([lp0, lp0 - step, lp0 + step], np.float32)
    special_adv = np.array([1.3, -0.7, 0.0], np.float32)
    sl, sa = np.meshgrid(special_lp, special_adv, indexing="ij")
    n_sp = sl.size
    u = np.concatenate([u, np.zeros((n_sp, 2), np.float32)])
    s = np.concatenate([s, np.zeros((n_sp, 2), np.float32)])
    act = np.concatenate([act, np.tile(act0, (n_sp, 1))])
    lp_b = np.concatenate([lp_b, sl.ravel()])
    adv = np.concatenate([adv, sa.ravel()])
    ent_c = 0.001

    n = u.shape[0]
    j_loss, j_gu, j_gs = _ppo_chain(
        jnp.asarray(u.T), jnp.asarray(s.T), jnp.asarray(act.T),
        jnp.asarray(lp_b[None]), jnp.asarray(adv[None]),
        jnp.ones((1, n), jnp.float32), 1, eps, ent_c)
    t_loss, t_gu, t_gs = um.ppo_chain(
        *(torch.tensor(x) for x in (u, s, act, lp_b, adv)), eps, ent_c)
    np.testing.assert_allclose(float(t_loss.sum()), float(j_loss[0, 0]),
                               rtol=1e-5)
    for got, want in ((t_gu.numpy(), np.asarray(j_gu).T),
                      (t_gs.numpy(), np.asarray(j_gs).T)):
        np.testing.assert_allclose(got[:n_rand], want[:n_rand], rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[n_rand:], want[n_rand:], rtol=1e-6,
                                   atol=1e-7)
    # The edge rows' gradients really carry the tie weights: with adv != 0
    # the x = 0 row and the on-edge row are not zero.
    assert np.abs(t_gs.numpy()[n_rand:]).min(axis=1)[[0, 1]].min() > 0


def test_critic_chain_matches_jax_at_ties_and_edges():
    """New values exactly on vold - eps and vold + eps (float32 arithmetic,
    the same in both frameworks), exactly vold (inside the band: d1 == d2
    ties), and random values in and out of the band."""
    rng = np.random.default_rng(1)
    eps = 0.01
    vold = rng.normal(size=32).astype(np.float32)
    ret = rng.normal(size=32).astype(np.float32)
    e32 = np.float32(eps)
    v = np.concatenate([vold - e32, vold + e32, vold,
                        vold + rng.normal(scale=0.02, size=32).astype(
                            np.float32)])
    vold4, ret4 = np.tile(vold, 4), np.tile(ret, 4)
    j_loss, j_gv = _critic_chain(jnp.asarray(v[None]), jnp.asarray(vold4[None]),
                                 jnp.asarray(ret4[None]),
                                 jnp.ones((1, v.size), jnp.float32), eps)
    t_loss, t_gv = um.critic_chain(torch.tensor(v), torch.tensor(vold4),
                                   torch.tensor(ret4), eps)
    np.testing.assert_allclose(float(t_loss.sum()), float(j_loss[0, 0]),
                               rtol=1e-6)
    np.testing.assert_allclose(t_gv.numpy(), np.asarray(j_gv)[0], rtol=1e-6,
                               atol=1e-7)
    # On an edge the clamp passes half the gradient: g_v differs from both
    # the unclamped 2 e1 and the fully-clamped values.
    assert not np.allclose(t_gv.numpy()[:64], 2.0 * (v - ret4)[:64])


# ----------------------------------------------------------------------
# Rows 4 and 5: the staged kernels, on every minibatch slice
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 128], ids=["one-block", "multi-block"])
@pytest.mark.parametrize("faithful", [True, False])
def test_grads_match_staged_kernels(p, faithful):
    """actor_grad / critic_grad (plain route) against the JAX affine actor
    kernel and the critic kernel in interpret mode on stage_*_minibatch,
    slice by slice (the faithful tail slice drops the last step)."""
    t = 12
    jc, tc = cfgs(p, t, batch_size=6, faithful=faithful)
    jb, tb = rand_buffer(0, t, p)
    ja = actor_init(jax.random.PRNGKey(1), OBS, H, 2)
    jcr = critic_init(jax.random.PRNGKey(3), OBS, A, H)
    ta, tcr = from_jax_params(jax.tree.map(np.asarray, (ja, jcr)))
    actor_k = jax.jit(make_fused_actor_grad(jc, interpret=True),
                      static_argnums=2)
    critic_k = jax.jit(make_fused_critic_grad(jc, interpret=True),
                       static_argnums=2)
    j_slices, t_slices = jm.minibatch_slices(jb, jc), tm.minibatch_slices(tb, tc)
    assert [s.obs.shape[0] for s in t_slices] == (
        [6, 5] if faithful else [6, 6])
    for j_mb, t_mb in zip(j_slices, t_slices):
        lj, gj = actor_k(ja, *stage_actor_minibatch(j_mb, jc))
        lt, gt = fu.actor_grad(ta, t_mb, tm.minibatch_advantages(t_mb, tc), tc)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           "actor")
        lj, gj = critic_k(jcr, *stage_critic_minibatch(j_mb, jc))
        lt, gt = fu.critic_grad(tcr, t_mb, tc)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           "critic")


def test_critic_grad_matches_kernel_inside_clip_band():
    """Old values set to the critic's current outputs: every row's new
    value sits inside the band, d1 == d2 everywhere, and each row's
    gradient splits 1/2 : 1/2 (tests/test_fused_update.py:103)."""
    t, p = 8, 8
    jc, tc = cfgs(p, t)
    jb, tb = rand_buffer(4, t, p)
    jcr = critic_init(jax.random.PRNGKey(5), OBS, A, H)
    _, tcr = from_jax_params(jax.tree.map(np.asarray, (
        actor_init(jax.random.PRNGKey(6), OBS, H, 2), jcr)))
    v_now = critic_apply(jcr, jb.obs.reshape(t * p, A, OBS)).reshape(t, p, 1)
    jb = jb._replace(values=v_now)
    tb = dataclasses.replace(tb, values=torch.tensor(np.asarray(v_now)))
    j_mb, t_mb = jm.minibatch_slices(jb, jc)[0], tm.minibatch_slices(tb, tc)[0]
    lj, gj = make_fused_critic_grad(jc, interpret=True)(
        jcr, *stage_critic_minibatch(j_mb, jc))
    lt, gt = fu.critic_grad(tcr, t_mb, tc)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
    assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5)


# Widths the JAX package trains beyond the defaults: -no 8 (obs 2 + 2*8 + 4
# = 22, critic input 3 x 22 = 66), -no 14 (obs 34, critic input 102), -hs
# 128 and -hs 256.
WIDE = {"no8-in66-h50": (22, 50), "hs128-in36-h128": (12, 128),
        "hs256-in36-h256": (12, 256), "no14-in102-h50": (34, 50)}


def wide_networks(obs, hidden):
    """JAX and port actor and critic of these widths, equal weights."""
    ja = actor_init(jax.random.PRNGKey(1), obs, hidden, 2)
    jcr = critic_init(jax.random.PRNGKey(3), obs, A, hidden)
    return (ja, jcr), from_jax_params(jax.tree.map(np.asarray, (ja, jcr)))


@pytest.mark.parametrize("width", sorted(WIDE))
def test_critic_grads_match_staged_kernel_at_wide_widths(width):
    """critic_grad (plain route) against the JAX critic kernel in interpret
    mode at the widths of -no 8 (In 66, H 50), -no 14 (In 102, H 50), -hs
    128 (In 36, H 128) and -hs 256 (In 36, H 256), slice by slice:
    rtol/atol 2e-5, as at the default width."""
    obs, hidden = WIDE[width]
    t, p = 12, 4
    jc, tc = cfgs(p, t, batch_size=6, obs_size=obs, hidden_size=hidden)
    jb, tb = rand_buffer(0, t, p, obs=obs)
    (_, jcr), (_, tcr) = wide_networks(obs, hidden)
    critic_k = jax.jit(make_fused_critic_grad(jc, interpret=True),
                       static_argnums=2)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        lj, gj = critic_k(jcr, *stage_critic_minibatch(j_mb, jc))
        lt, gt = fu.critic_grad(tcr, t_mb, tc)
        assert gt["fc1.weight"].shape == (hidden, A * obs)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           f"critic {width}")


# The affine actor kernel takes any obs width: those of -no 8 and -no 14,
# and an odd one (13), which the JAX staged kernel takes in interpret mode.
AFFINE_WIDE = {"no8-obs22": 22, "no14-obs34": 34, "odd-obs13": 13}


@pytest.mark.parametrize("width", sorted(AFFINE_WIDE))
def test_affine_grads_match_staged_kernel_at_wide_widths(width):
    """actor_grad (plain route) against the JAX affine actor kernel in
    interpret mode at obs 22, 34 and 13 (hidden 50), slice by slice:
    rtol/atol 2e-5, as at the default width."""
    obs = AFFINE_WIDE[width]
    t, p = 12, 4
    jc, tc = cfgs(p, t, batch_size=6, obs_size=obs, hidden_size=50)
    jb, tb = rand_buffer(0, t, p, obs=obs)
    (ja, _), (ta, _) = wide_networks(obs, 50)
    actor_k = jax.jit(make_fused_actor_grad(jc, interpret=True,
                                            layout="affine"),
                      static_argnums=2)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        lj, gj = actor_k(ja, *stage_actor_minibatch(j_mb, jc,
                                                    layout="affine"))
        lt, gt = fu.actor_grad(ta, t_mb, tm.minibatch_advantages(t_mb, tc), tc)
        assert gt["fc1.weight"].shape == (50, obs)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           f"affine actor, F {obs}")


# ----------------------------------------------------------------------
# Rows 2 and 3: the tiled (full-batch) trainers
# ----------------------------------------------------------------------

def tile_env_axis(x):
    """(T, rows, P) -> (T, rows, 8, NB*128), the kernel's env tiling
    (inverse of fused_rollout.untile)."""
    t, rows, p = x.shape
    nb = p // BLOCK_ENVS
    return (x.reshape(t, rows, nb, SUB, LANE).transpose(0, 1, 3, 2, 4)
            .reshape(t, rows, SUB, nb * LANE))


def tiled_from_buffer(buf):
    """The JAX collect kernel's tile outputs for a Buffer
    (tests/test_fused_update_tiled.py:43-50)."""
    t, p = buf.obs.shape[0], buf.obs.shape[1]
    obs = tile_env_axis(
        buf.obs.transpose(0, 2, 3, 1).reshape(t, A * OBS, p))
    actions = tile_env_axis(
        buf.actions.transpose(0, 2, 3, 1).reshape(t, 2 * A, p))
    log_probs = tile_env_axis(
        buf.log_probs.reshape(t, p, A).transpose(0, 2, 1))
    return TiledRollout(obs, actions, log_probs)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("net", ["actor", "critic"])
def test_fused_phase_matches_tiled_trainer(net, faithful):
    """The port's fused train_actor / train_critic (3 epochs of Adam, full
    batch, P=1024, T=8, hidden 50) against make_tiled_*_trainer in
    interpret mode on the same weights and buffer."""
    p, t = BLOCK_ENVS, 8
    kw = dict(num_agents=A, num_parallel=p, obs_size=OBS, num_total=t * p,
              buffer_len=t, batch_size=t, num_epochs=3, faithful=faithful,
              fused_updates=True)
    jc, tc = JMAPPOConfig(**kw), MAPPOConfig(**kw)
    j_mappo = j_make_mappo(jc, j_make_env(JEnvParams(num_parallel=p),
                                          JTriangleInit(num_parallel=p), None),
                           JNormalizerConfig(), JScalerConfig())
    j_ts0, _ = j_mappo.init(jax.random.PRNGKey(0))
    jb, tb = rand_buffer(1 if net == "actor" else 2, t, p, done_frac=0.1)
    make = (make_tiled_actor_trainer if net == "actor"
            else make_tiled_critic_trainer)
    j_ts, j_losses = jax.jit(make(jc, interpret=True))(
        j_ts0, jb, tiled_from_buffer(jb))

    ta, tcr = from_jax_params(jax.tree.map(np.asarray,
                                           (j_ts0.actor, j_ts0.critic)))
    t_ts = TrainState(ta, tcr, torch.optim.Adam(ta.parameters(), lr=tc.lr),
                      torch.optim.Adam(tcr.parameters(), lr=tc.lr))
    t_mappo = make_mappo(tc, make_env(EnvParams(num_parallel=p),
                                      TriangleInitConfig(num_parallel=p),
                                      "cpu"), NormalizerConfig(),
                         ScalerConfig())
    train = t_mappo.train_actor if net == "actor" else t_mappo.train_critic
    t_ts, t_losses = train(t_ts, tb)

    assert t_losses.shape == (3,)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses),
                               rtol=1e-4, atol=1e-5)
    assert_grads_close(module_flat(getattr(t_ts, net)),
                       jax_flat(getattr(j_ts, net)), 1e-4, 1e-5, net)


# ----------------------------------------------------------------------
# Against the port's own autograd
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_grads_match_autograd(mode):
    """On every slice of a 2-minibatch split, the fused loss and gradients
    equal autograd's of actor_loss / critic_loss."""
    t, p = 12, 4
    _, tc = cfgs(p, t, batch_size=6, **MODES[mode])
    _, tb = rand_buffer(5, t, p, mode)
    g = torch.Generator().manual_seed(6)
    from marlnav_tpu_torch.models import Actor, Critic

    actor, critic = Actor(OBS, H, generator=g), Critic(OBS, A, H, generator=g)
    for mb in tm.minibatch_slices(tb, tc):
        for module, loss_fn, fused in (
                (actor, tm.actor_loss, lambda: fu.actor_grad(
                    actor, mb, tm.minibatch_advantages(mb, tc), tc)),
                (critic, tm.critic_loss, lambda: fu.critic_grad(
                    critic, mb, tc))):
            module.zero_grad(set_to_none=True)
            loss = loss_fn(module, mb, tc)
            loss.backward()
            lf, gf = fused()
            np.testing.assert_allclose(float(lf), float(loss.detach()),
                                       rtol=1e-5)
            want = {k: p_.grad for k, p_ in module.named_parameters()}
            assert_grads_close(as_jax_layout(gf), as_jax_layout(want), 1e-4,
                               1e-6, loss_fn.__name__)


# ----------------------------------------------------------------------
# Routing (the kernels themselves: tests_cuda/test_cuda_fused_update.py)
# ----------------------------------------------------------------------

def _sum_inputs(n, f, h, device="cpu", seed=7):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    actor = (0.3 * r(4, f), r(4), r(n, f), r(n, 2).clamp(-1, 1),
             -1.0 + 0.5 * r(n), r(n))
    critic = (r(h, A * f) / 6.0, r(h), r(1, h) / 7.0, r(1), r(n, A * f),
              r(n), r(n))
    to = lambda xs: tuple(x.to(device) for x in xs)  # noqa: E731
    return to(actor), to(critic)


def test_cpu_routing_runs_plain_version_and_launches_nothing():
    """CPU tensors run the plain versions (exactly) and leave the launch
    counters alone; other non-CUDA devices raise."""
    actor_in, critic_in = _sum_inputs(50, OBS, H)
    before = (fu.actor_grad_sums.launches, fu.critic_grad_sums.launches)
    for got, want in (
            (fu.actor_grad_sums(*actor_in, 0.01, 0.001),
             um.actor_grad_sums_reference(*actor_in, 0.01, 0.001)),
            (fu.critic_grad_sums(*critic_in, 0.01),
             um.critic_grad_sums_reference(*critic_in, 0.01))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fu.actor_grad_sums.launches,
            fu.critic_grad_sums.launches) == before == (0, 0)
    assert fu.critic_grad_sums.pipelined_launches == 0
    assert fu.critic_grad_sums.rt_launches == 0
    meta_a = tuple(x.to("meta") for x in actor_in)
    meta_c = tuple(x.to("meta") for x in critic_in)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.actor_grad_sums(*meta_a, 0.01, 0.001)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.critic_grad_sums(*meta_c, 0.01)
    # The fused collect's operator feeds the actor kernel unchanged.
    assert fc._affine_compose is fu._affine_compose


def test_cpu_route_takes_widths_past_the_kernels():
    """The plain route takes widths past every kernel's (obs 256 for the
    affine actor, hidden 300 for the tensor-core kernels) and launches
    nothing: only the card raises there."""
    actor_in, critic_in = _sum_inputs(40, OBS, 300)
    wide_actor = _sum_inputs(40, 256, H)[0]
    outs = (fu.actor_grad_sums(*wide_actor, 0.01, 0.001),
            fu.critic_grad_sums(*critic_in, 0.01),
            fu.actor_grad_uncollapsed_sums(
                *_uncollapsed_inputs(40, OBS, 300), 0.01, 0.001))
    assert outs[0][1].shape == (4, 256) and outs[1][1].shape == (300, A * OBS)
    assert outs[2][1].shape == (300, OBS)
    assert all(bool(torch.isfinite(x).all()) for out in outs for x in out)
    assert (fu.actor_grad_sums.launches, fu.critic_grad_sums.launches,
            fu.actor_grad_uncollapsed_sums.launches) == (0, 0, 0)
    assert (fu.critic_grad_sums.rt_launches,
            fu.actor_grad_uncollapsed_sums.rt_launches) == (0, 0)
    assert (fu.critic_grad_sums.rt_one_pass_launches,
            fu.actor_grad_uncollapsed_sums.rt_one_pass_launches) == (0, 0)


def test_counted_graph_counts_every_counter_of_a_wrapper():
    """``CountedGraph`` counts each of ``graphs.COUNTERS`` a wrapper
    carries (the critic's ``launches``, ``pipelined_launches``,
    ``rt_launches`` and ``rt_one_pass_launches``) and leaves the others'
    alone: the critic kernel's wrapper carries all four, the un-collapsed
    actor's ``launches``, ``rt_launches`` and ``rt_one_pass_launches``, the
    collect's ``launches`` and ``rt_launches``, the other wrappers
    ``launches`` alone."""
    from marlnav_tpu_torch.ops import graphs

    wrappers = graphs.kernel_wrappers()
    carried = {name: [c for c in graphs.COUNTERS if hasattr(fn, c)]
               for name, fn in wrappers.items()}
    assert carried.pop("fused_critic_grad") == [
        "launches", "pipelined_launches", "rt_launches",
        "rt_one_pass_launches"]
    assert carried.pop("fused_actor_grad_uncollapsed") == [
        "launches", "rt_launches", "rt_one_pass_launches"]
    assert carried.pop("fused_collect") == ["launches", "rt_launches"]
    assert all(c == ["launches"] for c in carried.values())


# ----------------------------------------------------------------------
# Rows 6 and 7: the un-collapsed actor gradient
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 128], ids=["one-block", "multi-block"])
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("layout", ["packed", "undilated"])
def test_uncollapsed_grads_match_staged_kernels(layout, faithful, p):
    """actor_grad_uncollapsed (plain route) against the JAX actor kernel of
    the "packed" (row 6) or "undilated" (row 7) layout in interpret mode on
    stage_actor_minibatch of that layout, slice by slice: rtol/atol 2e-5,
    as the affine case above."""
    t = 12
    jc, tc = cfgs(p, t, batch_size=6, faithful=faithful)
    jb, tb = rand_buffer(0, t, p)
    ja = actor_init(jax.random.PRNGKey(1), OBS, H, 2)
    ta, _ = from_jax_params(jax.tree.map(np.asarray, (
        ja, critic_init(jax.random.PRNGKey(3), OBS, A, H))))
    actor_k = jax.jit(make_fused_actor_grad(jc, interpret=True, layout=layout),
                      static_argnums=2)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        lj, gj = actor_k(ja, *stage_actor_minibatch(j_mb, jc, layout=layout))
        lt, gt = fu.actor_grad_uncollapsed(
            ta, t_mb, tm.minibatch_advantages(t_mb, tc), tc)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           f"{layout} actor")


@pytest.mark.parametrize("layout", ["packed", "undilated"])
def test_uncollapsed_grads_match_staged_kernels_at_wide_width(layout):
    """actor_grad_uncollapsed (plain route) against the "packed" and
    "undilated" JAX actor kernels at F 22 (-no 8) and H 128 (-hs 128), P 4,
    slice by slice: rtol/atol 2e-5, as at the default width."""
    obs, hidden, t, p = 22, 128, 12, 4
    jc, tc = cfgs(p, t, batch_size=6, obs_size=obs, hidden_size=hidden)
    jb, tb = rand_buffer(0, t, p, obs=obs)
    (ja, _), (ta, _) = wide_networks(obs, hidden)
    actor_k = jax.jit(make_fused_actor_grad(jc, interpret=True, layout=layout),
                      static_argnums=2)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        lj, gj = actor_k(ja, *stage_actor_minibatch(j_mb, jc, layout=layout))
        lt, gt = fu.actor_grad_uncollapsed(
            ta, t_mb, tm.minibatch_advantages(t_mb, tc), tc)
        assert gt["fc1.weight"].shape == (hidden, obs)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           f"{layout} actor, F {obs} H {hidden}")


# -hs 256 (F 12, H 256: two passes of the kernel's tensor-core body) and
# -no 14 (F 34, H 50).
UNCOLLAPSED_WIDER = {"hs256-f12-h256": (12, 256), "no14-f34-h50": (34, 50)}


@pytest.mark.parametrize("width", sorted(UNCOLLAPSED_WIDER))
@pytest.mark.parametrize("layout", ["packed", "undilated"])
def test_uncollapsed_grads_match_staged_kernels_at_wider_widths(layout,
                                                                width):
    """As the test above, at the widths of -hs 256 and -no 14."""
    obs, hidden = UNCOLLAPSED_WIDER[width]
    t, p = 12, 4
    jc, tc = cfgs(p, t, batch_size=6, obs_size=obs, hidden_size=hidden)
    jb, tb = rand_buffer(0, t, p, obs=obs)
    (ja, _), (ta, _) = wide_networks(obs, hidden)
    actor_k = jax.jit(make_fused_actor_grad(jc, interpret=True, layout=layout),
                      static_argnums=2)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        lj, gj = actor_k(ja, *stage_actor_minibatch(j_mb, jc, layout=layout))
        lt, gt = fu.actor_grad_uncollapsed(
            ta, t_mb, tm.minibatch_advantages(t_mb, tc), tc)
        assert gt["fc1.weight"].shape == (hidden, obs)
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, atol=2e-5)
        assert_grads_close(as_jax_layout(gt), jax_flat(gj), 2e-5, 2e-5,
                           f"{layout} actor, F {obs} H {hidden}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_uncollapsed_grads_match_autograd(mode):
    """On every slice of a 2-minibatch split, the un-collapsed loss and
    gradients equal autograd's of actor_loss: loss rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-6."""
    t, p = 12, 4
    _, tc = cfgs(p, t, batch_size=6, **MODES[mode])
    _, tb = rand_buffer(5, t, p, mode)
    actor = Actor(OBS, H, generator=torch.Generator().manual_seed(6))
    for mb in tm.minibatch_slices(tb, tc):
        actor.zero_grad(set_to_none=True)
        loss = tm.actor_loss(actor, mb, tc)
        loss.backward()
        lf, gf = fu.actor_grad_uncollapsed(
            actor, mb, tm.minibatch_advantages(mb, tc), tc)
        np.testing.assert_allclose(float(lf), float(loss.detach()), rtol=1e-5)
        want = {k: p_.grad for k, p_ in actor.named_parameters()}
        assert_grads_close(as_jax_layout(gf), as_jax_layout(want), 1e-4, 1e-6,
                           "actor")


def _uncollapsed_inputs(n, f, h, device="cpu", seed=8):
    """Weights in nn.Linear layout (w1, b1, wmu, bmu, wvar, bvar), then
    obs, actions, log-probs and advantages of n rows.  The weights' scale
    falls with the fan-in (0.3 at F 12 and H 50), so that wider networks
    keep their log-prob ratios near 1."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    s1, s2 = 0.3 * (12 / f) ** 0.5, 0.3 * (50 / h) ** 0.5
    xs = (s1 * r(h, f), 0.1 * r(h), s2 * r(2, h), 0.1 * r(2), s2 * r(2, h),
          0.1 * r(2), r(n, f), r(n, 2).clamp(-1, 1), -1.0 + 0.5 * r(n), r(n))
    return tuple(x.to(device) for x in xs)


def test_uncollapsed_cpu_routing_runs_plain_version_and_launches_nothing():
    """CPU tensors run the plain version (exactly) and leave the launch
    counter alone; other non-CUDA devices raise."""
    args = _uncollapsed_inputs(50, OBS, H)
    got = fu.actor_grad_uncollapsed_sums(*args, 0.01, 0.001)
    want = um.actor_grad_sums_uncollapsed_reference(*args, 0.01, 0.001)
    assert [tuple(x.shape) for x in got] == [
        (), (H, OBS), (H,), (2, H), (2,), (2, H), (2,)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fu.actor_grad_uncollapsed_sums.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fu.actor_grad_uncollapsed_sums(*(x.to("meta") for x in args), 0.01,
                                       0.001)


# ----------------------------------------------------------------------
# The critic kernel's precision: its two products in 3xTF32
# ----------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(a, b, passes):
    """``a @ b`` as the critic kernel's tensor cores take it: float32
    operands split into TF32 halves, float32 accumulation; 3 passes
    (small·big + big·small + big·big, ops/csrc/mma_tf32.cuh) or 1."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def critic_sums_tf32(w1, b1, w2, b2, obs, vold, ret, eps, passes):
    """critic_grad_sums_reference with the kernel's two products: pre =
    [x | 1] [W1ᵀ ; b1] and [x | 1]ᵀ g_pre (dW1ᵀ, with db1 as its last
    row), each through ``tf32_product``."""
    x1 = torch.cat([obs, torch.ones(obs.shape[0], 1)], dim=1)
    h = torch.relu(tf32_product(x1, torch.cat([w1.T, b1[None]]), passes))
    v = h @ w2[0] + b2[0]
    loss_rows, g_v = um.critic_chain(v, vold, ret, eps)
    g_pre = g_v[:, None] * w2 * (h > 0.0).to(h.dtype)
    d = tf32_product(x1.T.contiguous(), g_pre, passes)
    return (loss_rows.sum(), d[:-1].T, d[-1], (g_v @ h)[None],
            g_v.sum()[None])


def test_tf32_split_reproduces_float32():
    """big = tf32(x), small = tf32(x - big): both TF32 values (low 13 bits
    clear), ties rounded away from zero, and big + small within one
    float32 ulp of x (relative 2^-23), where big alone keeps 11 bits."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=100_000) * 10.0 ** rng.uniform(
        -6, 6, size=100_000), dtype=torch.float32)
    big = tf32_round(x)
    small = tf32_round(x - big)
    for half in (big, small):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    rel = lambda y: ((y.double() - x.double()).abs()  # noqa: E731
                     / x.double().abs()).max().item()
    assert rel(big + small) <= 2.0 ** -23
    assert 2.0 ** -13 < rel(big) <= 2.0 ** -11
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_round(tie).tolist() == [1.0 + 2.0 ** -10,
                                        -(1.0 + 2.0 ** -10)]


def test_critic_sums_need_three_tf32_passes():
    """On 8,192 rand_buffer rows (In 36, H 50) through a freshly
    initialised critic, the critic's sums with 3-pass TF32 products stay
    within 2x of the float32 plain version's error against float64, output
    by output (each sum divided by the row count, as Adam sees it); with
    one pass the error on dW1 is more than twice the plain version's."""
    t, p = 64, 128
    _, tb = rand_buffer(9, t, p)
    n = t * p
    from marlnav_tpu_torch.models import Critic

    critic = Critic(OBS, A, 50, generator=torch.Generator().manual_seed(10))
    args = (critic.fc1.weight.detach(), critic.fc1.bias.detach(),
            critic.fc2.weight.detach(), critic.fc2.bias.detach(),
            tb.obs.reshape(n, -1), tb.values.reshape(n),
            tb.returns.reshape(n))
    eps = 0.2
    want = um.critic_grad_sums_reference(*(x.double() for x in args), eps)
    names = ("loss", "dW1", "db1", "dW2", "db2")

    def errors(got):
        return {k: ((g.double() - w) / n).abs().max().item()
                for k, g, w in zip(names, got, want)}

    plain = errors(um.critic_grad_sums_reference(*args, eps))
    three = errors(critic_sums_tf32(*args, eps, passes=3))
    one = errors(critic_sums_tf32(*args, eps, passes=1))
    for k in names:
        assert three[k] <= 2.0 * plain[k], (k, three[k], plain[k])
    assert one["dW1"] > 2.0 * plain["dW1"], (one["dW1"], plain["dW1"])


def uncollapsed_sums_tf32(w1, b1, wmu, bmu, wvar, bvar, obs, actions,
                          log_probs, adv, eps, ent_c, passes):
    """actor_grad_sums_uncollapsed_reference with the kernel's three
    products through ``tf32_product``: h = [x | 1] [W1ᵀ ; b1], [x | 1]ᵀ
    g_h (dW1ᵀ, with db1 as its last row) and g_zᵀ h (dWmu, then dWvar);
    the heads, the chain, g_h and the bias sums stay float32."""
    x1 = torch.cat([obs, torch.ones(obs.shape[0], 1)], dim=1)
    h = tf32_product(x1, torch.cat([w1.T, b1[None]]), passes)
    u = h @ wmu.T + bmu
    s = h @ wvar.T + bvar
    loss_rows, g_u, g_s = um.ppo_chain(u, s, actions, log_probs, adv, eps,
                                       ent_c)
    g_h = g_u @ wmu + g_s @ wvar
    d = tf32_product(x1.T.contiguous(), g_h, passes)
    dwh = tf32_product(torch.cat([g_u, g_s], dim=1).T.contiguous(), h,
                       passes)
    return (loss_rows.sum(), d[:-1].T, d[-1], dwh[:2], g_u.sum(0), dwh[2:],
            g_s.sum(0))


@pytest.mark.parametrize("obs,hidden", [(OBS, 50), (22, 128)],
                         ids=["default", "no8-hs128"])
def test_uncollapsed_sums_need_three_tf32_passes(obs, hidden):
    """On 24,576 rand_buffer actor rows through a freshly initialised actor
    (F 12, H 50, and the widest widths users train, F 22, H 128), the
    un-collapsed sums with the kernel's 3-pass TF32 products stay within 2x
    of the float32 plain version's error against float64, output by output
    (each sum divided by the row count), as the critic's do; with one pass
    the error on dW1 is more than twice the plain version's."""
    t, p = 64, 128
    _, tb = rand_buffer(12, t, p, obs=obs)
    n = t * p * A
    actor = Actor(obs, hidden, generator=torch.Generator().manual_seed(13))
    adv = torch.tensor(np.random.default_rng(14).normal(size=n),
                       dtype=torch.float32)
    args = (*(p_.detach() for p_ in actor.parameters()),
            tb.obs.reshape(n, -1), tb.actions.reshape(n, -1),
            tb.log_probs.reshape(n), adv)
    eps, ent_c = 0.2, 0.001
    want = um.actor_grad_sums_uncollapsed_reference(
        *(x.double() for x in args), eps, ent_c)
    names = ("loss", "dW1", "db1", "dWmu", "dbmu", "dWvar", "dbvar")

    def errors(got):
        return {k: ((g.double() - w) / n).abs().max().item()
                for k, g, w in zip(names, got, want)}

    plain = errors(um.actor_grad_sums_uncollapsed_reference(*args, eps,
                                                            ent_c))
    three = errors(uncollapsed_sums_tf32(*args, eps, ent_c, passes=3))
    one = errors(uncollapsed_sums_tf32(*args, eps, ent_c, passes=1))
    for k in names:
        assert three[k] <= 2.0 * plain[k], (k, three[k], plain[k])
    assert one["dW1"] > 2.0 * plain["dW1"], (one["dW1"], plain["dW1"])
