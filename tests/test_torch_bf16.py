"""``--bf16-updates`` in the port against the JAX package, route by route.

The JAX package rounds its update products' operands to bf16 at different
points on each route (``_dot(..., dtype)``, marlnav_tpu/ops/
fused_update.py:429, and the tiled actor's explicit casts,
fused_update_tiled.py:199-204), so each port route is held against the
JAX route it stands for, on the same numpy-seeded inputs and the same
weights (``from_jax_params``):

* the affine actor, "tiled" rounding, against ``make_tiled_actor_grad``
  (interpret mode, P = 1024, full batch);
* the affine actor, "staged" rounding, against the staged affine kernel
  (``make_fused_actor_grad(layout="affine")``) on every minibatch slice;
* the critic against ``make_fused_critic_grad`` and
  ``make_tiled_critic_grad``;
* the un-collapsed actor against the "packed" and "undilated" kernels;
* the autograd losses against ``jax.jit(jax.value_and_grad(actor_loss /
  critic_loss))``, both with ``bf16_updates=True`` (jitted, as the JAX
  package trains: XLA sums a hidden activation's two bf16 cotangents in
  float32, where eager JAX rounds the sum to bf16).

The criterion, per output and for the loss: |port - jax_bf16| <= 1/4
|jax_bf16 - jax_f32| (max norms).  The bf16 - float32 gap is what the
rounding points make, so this tells the right ones from wrong ones; the
float32 noise between the frameworks is far below it.  An output that the
route's rounding does not reach (the tiled actor's loss: its forward is
unrounded) has no gap, and is held to the float32 tolerance of
``tests/test_torch_fused_update.py`` (rtol 2e-5 / atol 2e-5) instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import Buffer as JBuffer
from marlnav_tpu.algo import mappo as jm
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.models import actor_init, critic_init
from marlnav_tpu.ops.fused_update import (
    make_fused_actor_grad,
    make_fused_critic_grad,
    stage_actor_minibatch,
    stage_critic_minibatch,
)
from marlnav_tpu.ops.fused_update_tiled import (
    TiledRollout,
    make_tiled_actor_grad,
    make_tiled_critic_grad,
    stage_adv_tiled,
    stage_vr_tiled,
)
from marlnav_tpu.ops.step_math import BLOCK_ENVS, LANE, SUB
from marlnav_tpu_torch.__main__ import cli
from marlnav_tpu_torch.algo import mappo as tm
from marlnav_tpu_torch.algo.mappo import Buffer
from marlnav_tpu_torch.config import MAPPOConfig
from marlnav_tpu_torch.models import from_jax_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import update_math as um

A, OBS, H = 3, 12, 50


def cfgs(p, t, bf16, **kw):
    base = dict(num_agents=A, num_parallel=p, obs_size=OBS, hidden_size=H,
                num_total=t * p, buffer_len=t, num_epochs=2, batch_size=t,
                bf16_updates=bf16)
    base.update(kw)
    return JMAPPOConfig(**base), MAPPOConfig(**base)


def rand_buffer(seed, t, p, obs=OBS):
    """One numpy buffer handed to both packages."""
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.normal(size=(t, p, A, obs)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(t, p, A, 2)).astype(np.float32),
        log_probs=rng.normal(-1.0, 0.5, size=(t, p * A)).astype(np.float32),
        values=rng.normal(size=(t, p, 1)).astype(np.float32),
        returns=rng.normal(size=(t, p)).astype(np.float32),
        done=rng.uniform(size=(t, p)) < 0.2)
    return (JBuffer(**{k: jnp.asarray(v) for k, v in b.items()}),
            Buffer(**{k: torch.tensor(v) for k, v in b.items()}))


def networks(seed=1, obs=OBS, hidden=H):
    """JAX and port actor and critic, equal weights."""
    ja = actor_init(jax.random.PRNGKey(seed), obs, hidden, 2)
    jcr = critic_init(jax.random.PRNGKey(seed + 2), obs, A, hidden)
    return (ja, jcr), from_jax_params(jax.tree.map(np.asarray, (ja, jcr)))


def jax_out(loss, grads):
    """{"loss": (), "fc1.w": (in, out), ...} of a JAX (loss, params)."""
    out = {"loss": np.asarray(loss)}
    for name, dense in grads._asdict().items():
        out[f"{name}.w"], out[f"{name}.b"] = (np.asarray(dense.w),
                                              np.asarray(dense.b))
    return out


def port_out(loss, grads):
    """The same keys and layout from the port's (loss, grads by parameter
    name)."""
    out = {"loss": loss.detach().numpy()}
    for k, g in grads.items():
        g = g.detach().numpy()
        out[k.replace(".weight", ".w").replace(".bias", ".b")] = (
            g.T if k.endswith("weight") else g)
    return out


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def is_bf16(x):
    return np.array_equal(um.round_bf16(torch.tensor(x)).numpy(), x)


def assert_bf16_route(port, jax_bf16, jax_f32, what):
    """Each output within a quarter of the JAX route's own bf16 - float32
    gap; one with no gap within the float32 tolerance.  An output that the
    route itself rounds to bf16 (autograd's weight gradients: the
    transpose of the weight's cast) may take the neighbouring bf16 value
    where float32 noise in the sum before that rounding crosses a rounding
    boundary: each element equal or one bf16 step away, at most 1% of them
    away (0.3% measured; rounding at the wrong points moves ~30%).  At
    least one output must have a gap: the route rounds something."""
    assert set(port) == set(jax_bf16) == set(jax_f32)
    gaps = []
    for key in sorted(jax_bf16):
        want = jax_bf16[key]
        gap = float(np.abs(want - jax_f32[key]).max())
        err = float(np.abs(port[key] - want).max())
        if gap > 0.0 and want.size > 1 and is_bf16(want) and is_bf16(
                port[key]):
            away = port[key] != want
            step = np.abs(port[key] - want)[away]
            assert (step <= bf16_ulp(np.maximum(np.abs(want), np.abs(
                port[key])))[away]).all(), f"{what} {key}: > 1 bf16 step"
            assert away.mean() <= 0.01, (
                f"{what} {key}: {away.mean():.1%} of the bf16 values differ")
            gaps.append(gap)
        elif gap > 0.0:
            assert err <= 0.25 * gap, (
                f"{what} {key}: |port - jax_bf16| {err:.3e} > 1/4 of the "
                f"bf16 - f32 gap {gap:.3e}")
            gaps.append(gap)
        else:
            np.testing.assert_allclose(port[key], want, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{what} {key} (no gap)")
    assert gaps, f"{what}: bf16 changed nothing"


# ----------------------------------------------------------------------
# The affine actor: the tiled route (full batch) and the staged one
# ----------------------------------------------------------------------

def tile_env_axis(x):
    """(T, rows, P) -> (T, rows, 8, NB*128), the collect kernel's env
    tiling (inverse of fused_rollout.untile)."""
    t, rows, p = x.shape
    nb = p // BLOCK_ENVS
    return (x.reshape(t, rows, nb, SUB, LANE).transpose(0, 1, 3, 2, 4)
            .reshape(t, rows, SUB, nb * LANE))


def tiled_from_buffer(buf):
    """The JAX collect kernel's tile outputs for a Buffer slice."""
    t, p = buf.obs.shape[0], buf.obs.shape[1]
    return TiledRollout(
        tile_env_axis(buf.obs.transpose(0, 2, 3, 1).reshape(t, A * OBS, p)),
        tile_env_axis(buf.actions.transpose(0, 2, 3, 1).reshape(t, 2 * A, p)),
        tile_env_axis(buf.log_probs.reshape(t, p, A).transpose(0, 2, 1)))


@pytest.mark.parametrize("faithful", [True, False])
def test_affine_tiled_matches_tiled_kernel(faithful):
    """actor_grad(..., tiled=True) against make_tiled_actor_grad in
    interpret mode: the full-batch slice (faithful: T - 1 steps) of P =
    1024 envs, the tiled trainer's pairing within the slice."""
    p, t = BLOCK_ENVS, 5
    (ja, _), (ta, _) = networks()
    jb, tb = rand_buffer(0, t, p)
    outs = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16, faithful=faithful)
        j_mb = jm.minibatch_slices(jb, jc)[0]
        adv_t = stage_adv_tiled(j_mb.returns, j_mb.values, jc)
        outs[bf16] = jax_out(*make_tiled_actor_grad(jc, interpret=True)(
            ja, tiled_from_buffer(j_mb), adv_t))
    t_mb = tm.minibatch_slices(tb, tc)[0]
    assert t_mb.obs.shape[0] == (t - 1 if faithful else t)
    port = port_out(*fu.actor_grad(ta, t_mb, tm.minibatch_advantages(t_mb, tc),
                                   tc, tiled=True))
    assert_bf16_route(port, outs[True], outs[False], "affine tiled")
    # The tiled route rounds nothing of the forward: the loss is float32's.
    assert outs[True]["loss"] == outs[False]["loss"]


def staged_kernels(layout, p, t, bs, seed=0):
    """(JAX bf16 and float32 outputs, port outputs) on every minibatch
    slice of one buffer through the staged actor kernel of ``layout``
    ("affine", "packed" or "undilated") and the port's actor route that
    stands for it."""
    (ja, _), (ta, _) = networks()
    jb, tb = rand_buffer(seed, t, p)
    per_slice = []
    kernels = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16, batch_size=bs)
        kernels[bf16] = jax.jit(make_fused_actor_grad(jc, interpret=True,
                                                      layout=layout),
                                static_argnums=2)
    port_grad = (fu.actor_grad if layout == "affine"
                 else fu.actor_grad_uncollapsed)
    for j_mb, t_mb in zip(jm.minibatch_slices(jb, jc),
                          tm.minibatch_slices(tb, tc)):
        staged = stage_actor_minibatch(j_mb, jc, layout=layout)
        j = {bf16: jax_out(*k(ja, *staged)) for bf16, k in kernels.items()}
        port = port_out(*port_grad(ta, t_mb,
                                   tm.minibatch_advantages(t_mb, tc), tc))
        per_slice.append((port, j[True], j[False]))
    return per_slice


def test_affine_staged_matches_staged_kernel():
    """actor_grad (staged rounding) against the JAX staged affine kernel
    in interpret mode, on both minibatch slices (the faithful tail drops
    the last step)."""
    for i, (port, jb16, jf32) in enumerate(staged_kernels("affine", 128, 12,
                                                          6)):
        assert_bf16_route(port, jb16, jf32, f"affine staged, slice {i}")


@pytest.mark.parametrize("layout", ["packed", "undilated"])
def test_uncollapsed_matches_staged_kernel(layout):
    """actor_grad_uncollapsed against the JAX "packed" and "undilated"
    kernels in interpret mode, on both minibatch slices."""
    for i, (port, jb16, jf32) in enumerate(staged_kernels(layout, 128, 12,
                                                          6, seed=1)):
        assert_bf16_route(port, jb16, jf32, f"{layout}, slice {i}")


def test_affine_roundings_differ():
    """A mutation check of the switch: on the same inputs the tiled and
    the staged roundings give different sums (the staged one rounds the
    forward, so its g_z differs; the tiled one sums the rounded g_z), and
    each differs from float32: the mode reaches the rounding."""
    rng = np.random.default_rng(7)
    n = 4096
    a_comp = torch.tensor(rng.normal(size=(4, OBS)).astype(np.float32)) * 0.3
    c_comp = torch.tensor(rng.normal(size=4).astype(np.float32))
    rows = (torch.tensor(rng.normal(size=(n, OBS)).astype(np.float32)),
            torch.tensor(rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)),
            torch.tensor(rng.normal(-1, 0.5, size=n).astype(np.float32)),
            torch.tensor(rng.normal(size=n).astype(np.float32)))
    sums = {mode: fu.actor_grad_sums(a_comp, c_comp, *rows, 0.2, 0.001, mode)
            for mode in (None, "tiled", "staged")}
    for out in (1, 2):  # dz, dzs
        assert not torch.equal(sums["tiled"][out], sums["staged"][out])
        for mode in ("tiled", "staged"):
            assert not torch.equal(sums[mode][out], sums[None][out])
    assert torch.equal(sums["tiled"][0], sums[None][0])  # forward unrounded
    assert not torch.equal(sums["staged"][0], sums[None][0])
    with pytest.raises(ValueError, match="bf16 rounding"):
        fu.actor_grad_sums(a_comp, c_comp, *rows, 0.2, 0.001, "bf16")


# ----------------------------------------------------------------------
# The critic: the staged kernel and the tiled one
# ----------------------------------------------------------------------

def test_critic_matches_staged_kernel():
    """critic_grad against make_fused_critic_grad in interpret mode on
    both minibatch slices."""
    p, t = 128, 12
    (_, jcr), (_, tcr) = networks(3)
    jb, tb = rand_buffer(2, t, p)
    kernels = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16, batch_size=6)
        kernels[bf16] = jax.jit(make_fused_critic_grad(jc, interpret=True),
                                static_argnums=2)
    for i, (j_mb, t_mb) in enumerate(zip(jm.minibatch_slices(jb, jc),
                                         tm.minibatch_slices(tb, tc))):
        staged = stage_critic_minibatch(j_mb, jc)
        j = {bf16: jax_out(*k(jcr, *staged)) for bf16, k in kernels.items()}
        port = port_out(*fu.critic_grad(tcr, t_mb, tc))
        assert_bf16_route(port, j[True], j[False], f"critic, slice {i}")


def test_critic_matches_tiled_kernel():
    """critic_grad against make_tiled_critic_grad in interpret mode: the
    faithful full-batch slice (T - 1 steps) of P = 1024 envs."""
    p, t = BLOCK_ENVS, 4
    (_, jcr), (_, tcr) = networks(5)
    jb, tb = rand_buffer(3, t, p)
    outs = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16)
        j_mb = jm.minibatch_slices(jb, jc)[0]
        tiles = tiled_from_buffer(j_mb).obs
        outs[bf16] = jax_out(*make_tiled_critic_grad(jc, interpret=True)(
            jcr, tiles, stage_vr_tiled(j_mb.values[..., 0]),
            stage_vr_tiled(j_mb.returns)))
    port = port_out(*fu.critic_grad(tcr, tm.minibatch_slices(tb, tc)[0], tc))
    assert_bf16_route(port, outs[True], outs[False], "critic tiled")


# ----------------------------------------------------------------------
# Autograd: the losses through Actor / Critic with compute_dtype
# ----------------------------------------------------------------------

@pytest.mark.parametrize("net", ["actor", "critic"])
@pytest.mark.parametrize("faithful", [True, False])
def test_autograd_matches_value_and_grad(net, faithful):
    """The port's autograd loss and gradients (bf16 operands rounded in
    the forward, each operand's gradient rounded once in the backward)
    against jax.value_and_grad of the JAX loss with bf16_updates, on both
    minibatch slices."""
    p, t = 64, 12
    (ja, jcr), (ta, tcr) = networks(7)
    jb, tb = rand_buffer(4, t, p)
    j_params, t_module = (ja, ta) if net == "actor" else (jcr, tcr)
    j_loss_fn = jm.actor_loss if net == "actor" else jm.critic_loss
    t_loss_fn = tm.actor_loss if net == "actor" else tm.critic_loss
    j = {}
    for bf16 in (False, True):
        jc, tc = cfgs(p, t, bf16, batch_size=6, faithful=faithful)
        vg = jax.jit(jax.value_and_grad(lambda prm, mb, c=jc: j_loss_fn(
            prm, mb, c)))
        j[bf16] = [jax_out(*vg(j_params, mb))
                   for mb in jm.minibatch_slices(jb, jc)]
    for i, t_mb in enumerate(tm.minibatch_slices(tb, tc)):
        t_module.zero_grad(set_to_none=True)
        loss = t_loss_fn(t_module, t_mb, tc)
        loss.backward()
        port = port_out(loss, {k: p_.grad for k, p_ in
                               t_module.named_parameters()})
        assert_bf16_route(port, j[True][i], j[False][i],
                          f"{net} autograd, slice {i}")


def test_compute_dtype_none_is_float32_forward():
    """compute_dtype=None leaves the networks' forward as it was: equal to
    nn.Linear's own, bit for bit; bf16 moves it."""
    (_, _), (ta, tcr) = networks(9)
    obs = torch.tensor(np.random.default_rng(0).normal(
        size=(32, A, OBS)).astype(np.float32))
    with torch.no_grad():
        x = obs.reshape(-1, OBS)
        h = ta.fc1(x)
        assert torch.equal(ta(obs)[0], torch.tanh(ta.fc_mu(h)))
        v = tcr.fc2(torch.relu(tcr.fc1(obs.reshape(32, -1))))
        assert torch.equal(tcr(obs), v)
        assert not torch.equal(tcr(obs, torch.bfloat16), v)
        assert not torch.equal(ta(obs, torch.bfloat16)[0], ta(obs)[0])


# ----------------------------------------------------------------------
# The plain versions' float64 accumulation, and the CLI
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["affine", "critic", "uncollapsed"])
def test_acc_float64_sums_the_same_rounded_products(kernel):
    """acc=float64 takes the products of the same bf16-rounded operands in
    float64: the float32 plain version lies within float32 accumulation
    noise of it (far inside the bf16 - float32 gap), and an acc of the
    inputs' own dtype changes nothing."""
    rng = np.random.default_rng(11)
    n, f, h = 2048, OBS, H
    x = torch.tensor(rng.normal(size=(n, f)).astype(np.float32))
    act = torch.tensor(rng.uniform(-1, 1, size=(n, 2)).astype(np.float32))
    lp = torch.tensor(rng.normal(-1, 0.5, size=n).astype(np.float32))
    adv = torch.tensor(rng.normal(size=n).astype(np.float32))
    (_, _), (ta, tcr) = networks(13, obs=f)
    if kernel == "affine":
        fn = um.actor_grad_sums_reference
        args = (*fc._affine_compose(ta), x, act, lp, adv, 0.2, 0.001)
        mode = "staged"
    elif kernel == "uncollapsed":
        fn = um.actor_grad_sums_uncollapsed_reference
        args = (*(p_.detach() for p_ in ta.parameters()), x, act, lp, adv,
                0.2, 0.001)
        mode = True
    else:
        fn = um.critic_grad_sums_reference
        xc = torch.tensor(rng.normal(size=(n, A * f)).astype(np.float32))
        args = (*(p_.detach() for p_ in tcr.parameters()), xc, adv, lp, 0.2)
        mode = True
    f32, f64 = fn(*args, mode), fn(*args, mode, torch.float64)
    plain = fn(*args)
    same = fn(*args, mode, torch.float32)
    for a, b, c, d in zip(f32, f64, plain, same):
        assert b.dtype == torch.float64 and torch.equal(a, d)
        scale = float(b.abs().max()) + 1e-30
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale
        assert float((c - a).abs().max()) > 0.0 or float(b.abs().max()) == 0


TINY = ["--device", "cpu", "-np", "8", "-bl", "20", "-ne", "2", "-se", "3",
        "-nt", "160"]


@pytest.mark.parametrize("route", [
    [], ["--fused-updates"], ["--fused-updates", "-bs", "10"],
    ["--fused-collect", "--fused-updates"]],
    ids=["autograd", "fused", "fused-sliced", "tiled"])
def test_cli_trains_bf16(route, tmp_path):
    """cli(... --bf16-updates --device cpu) trains one short repeat on each
    update route with finite losses, and moves the weights other than
    float32 does."""
    argv = TINY + ["--output-root", str(tmp_path)] + route
    if "-bs" not in route:
        argv += ["-bs", "20"]
    ts16, _, log16 = cli(argv + ["--bf16-updates"])
    ts32, _, _ = cli(argv)
    losses = log16.logs["actor"] + log16.logs["critic"]
    assert len(log16.logs["mean_rews"]) == 1 and losses
    assert np.isfinite(losses).all()
    assert not torch.equal(ts16.actor.fc1.weight, ts32.actor.fc1.weight)
    assert not torch.equal(ts16.critic.fc1.weight, ts32.critic.fc1.weight)


def test_tiled_route_follows_the_jax_package(monkeypatch):
    """train.tiled_route: full batch with --fused-collect --fused-updates,
    unless MARLNAV_TILED_UPDATES turns it off."""
    from marlnav_tpu_torch.train import tiled_route

    _, cfg = cfgs(8, 20, True, fused_updates=True)
    monkeypatch.delenv("MARLNAV_TILED_UPDATES", raising=False)
    assert tiled_route(cfg, True)
    assert not tiled_route(cfg, False)
    assert not tiled_route(dataclasses.replace(cfg, batch_size=10), True)
    assert not tiled_route(dataclasses.replace(cfg, fused_updates=False),
                           True)
    monkeypatch.setenv("MARLNAV_TILED_UPDATES", "off")
    assert not tiled_route(cfg, True)
