"""The fused collect's plain PyTorch version against the JAX package's
Pallas collect kernel (interpret mode, host-injected uniforms), plus the
CPU routing of the port's kernel wrapper.

Both sides consume the same uniforms: the JAX kernel takes them in its
tile layout (T, n_draws, 8, P/8), the port in (T, n_draws, P), mapped by
``noise_per_env`` as tests/test_fused_collect.py does.  Both run the same
float32 step math (Hastings acos, bounded sin/cos polynomials), so the
differences are last-ulp ones between two frameworks' tanh/log/exp and
reduction orders.

Tolerances (those of tests/test_fused_collect.py:148-160): obs rtol 1e-4,
atol 5e-4 (view angles near dot ~ 1, where acos amplifies one ulp of the
dot to 3.45e-4 rad); actions 1e-4; log-probs and values 1e-3; returns
rtol 1e-3, atol 2e-3 (the JAX collect reduces its returns with an
associative scan, the port with the sequential loop); done and the
episode counters exactly.  Multi-step cases use ``tame_policy``: an
untamed random actor steers up to +-pi per step and amplifies ulp
differences chaotically within a few steps.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against
this plain version on the card, and so does
``tests_cuda/test_cuda_fused_collect.py``, which chip_smoke.py runs.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import make_mappo as j_make_mappo
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.ops import env_state_to_rows as j_env_state_to_rows
from marlnav_tpu.ops import make_fused_collect as j_make_fused_collect
from marlnav_tpu.ops import step_math as j_step_math
from marlnav_tpu.ops.fused_update import _affine_compose as j_affine_compose
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.models import from_jax_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import step_math as t_step_math
from marlnav_tpu_torch.utils.seeding import make_generator

P, A, O = 1024, 3, 3


class TS:
    """The two fields of a TrainState that collect reads."""

    def __init__(self, actor, critic):
        self.actor, self.critic = actor, critic


def tame_policy(ts):
    """tests/test_fused_collect.py tame_policy: mean head x1e-3, variance
    bias -20, so trajectories stay near-straight and no env collides."""
    actor = ts.actor._replace(
        fc_mu=ts.actor.fc_mu._replace(w=ts.actor.fc_mu.w * 1e-3,
                                      b=ts.actor.fc_mu.b * 1e-3),
        fc_var=ts.actor.fc_var._replace(b=ts.actor.fc_var.b - 20.0))
    return ts._replace(actor=actor)


def noise_per_env(noise):
    """(T, k, 8, nb*128) tile layout -> (T, k, P), fused_rollout.untile's
    env mapping (tests/test_fused_collect.py:80-86)."""
    t, k = noise.shape[0], noise.shape[1]
    nb = noise.shape[3] // 128
    return np.asarray(noise).reshape(t, k, 8, nb, 128).transpose(
        0, 1, 3, 2, 4).reshape(t, k, nb * 8 * 128)


def run_both(t, episode_len=200, noisy=False, tame=True, env=None, **mode):
    """One collect of t steps through the JAX kernel (interpret mode) and
    the port's collect (CPU: the plain version), from the same state,
    weights and uniforms; ``env``: more env params (reward factors)."""
    kw = dict(num_parallel=P, buffer_len=t, batch_size=t, num_epochs=1,
              num_total=t * P, **mode)
    ep_kw = dict(num_parallel=P, num_agents=A, episode_len=episode_len,
                 **(env or {}))
    ic_kw = dict(num_parallel=P, num_obstacles=O, noisy_ags=noisy)
    j_cfg, j_ep, j_ic = (JMAPPOConfig(**kw), JEnvParams(**ep_kw),
                         JTriangleInit(**ic_kw))
    j_env = j_make_env(j_ep, j_ic, None)
    ts, s0 = j_make_mappo(j_cfg, j_env, JNormalizerConfig(),
                          JScalerConfig()).init(jax.random.PRNGKey(0))
    if tame:
        ts = tame_policy(ts)
    n_draws = 2 * A + 2 * O + (3 * A if noisy else 0)
    noise = jax.random.uniform(jax.random.PRNGKey(5), (t, n_draws, 8, P // 8),
                               jnp.float32)
    j_collect = j_make_fused_collect(j_cfg, j_ep, j_ic, JNormalizerConfig(),
                                     JScalerConfig(), interpret=True,
                                     noise_input=True)
    j_rows, j_buf, j_met = j_collect(ts, j_env_state_to_rows(s0), 7,
                                     noise=noise)

    actor, critic = from_jax_params(jax.tree.map(np.asarray,
                                                 (ts.actor, ts.critic)))
    state = EnvState(*(torch.tensor(np.asarray(x)) for x in
                       (s0.states, s0.obstacles, s0.target, s0.step_num,
                        s0.terminates)), EpisodeStats.zeros("cpu"),
                     make_generator(0))
    t_collect = fc.make_fused_collect(
        MAPPOConfig(**kw), EnvParams(**ep_kw), TriangleInitConfig(**ic_kw),
        NormalizerConfig(), ScalerConfig())
    t_rows, t_buf, t_met = t_collect(TS(actor, critic),
                                     fc.env_state_to_rows(state), 7,
                                     noise=torch.tensor(noise_per_env(noise)))
    return (j_rows, j_buf, j_met), (t_rows, t_buf, t_met)


def assert_buffers_match(j, t):
    (j_rows, j_buf, j_met), (t_rows, t_buf, t_met) = j, t
    np.testing.assert_array_equal(t_buf.done.numpy(), np.asarray(j_buf.done))
    for name, rtol, atol in (("obs", 1e-4, 5e-4), ("actions", 1e-4, 1e-4),
                             ("log_probs", 1e-3, 1e-3),
                             ("values", 1e-3, 1e-3),
                             ("returns", 1e-3, 2e-3)):
        np.testing.assert_allclose(getattr(t_buf, name).numpy(),
                                   np.asarray(getattr(j_buf, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_allclose(float(t_met.mean_rew), float(j_met.mean_rew),
                               rtol=1e-4)
    for name in ("num_trunc", "num_col", "num_tar"):
        assert int(getattr(t_met.stats, name)) == int(
            getattr(j_met.stats, name)), name
    for x, y, name in zip(t_rows.fields(), j_rows, t_rows.__dataclass_fields__):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("mode", ["faithful", "gae"])
def test_plain_collect_matches_jax_kernel(mode):
    """T=8 tamed: no env finishes, every buffer field and the final state
    match (GAE mode adds the final-state bootstrap value)."""
    j, t = run_both(8, **({} if mode == "faithful" else
                          dict(faithful=False, use_gae=True)))
    assert not np.asarray(j[1].done).any()  # premise: nothing finished
    assert_buffers_match(j, t)


def test_plain_collect_matches_jax_kernel_through_resets():
    """episode_len=4, T=8, noisy_ags: every env truncates at steps 3 and 7
    and redraws obstacles, positions and headings from the injected reset
    uniforms; both sides read the same draws, so every buffer field after a
    reset and the final state must match too.  Pins the reset-draw
    indexing ([0, 2A) actions, obstacle x, obstacle y, 3 per agent)."""
    j, t = run_both(8, episode_len=4, noisy=True)
    done = np.asarray(j[1].done)
    assert done[3].all() and done[7].all() and not done[[0, 1, 2, 4, 5, 6]].any()
    assert int(j[2].stats.num_trunc) == 2 * P
    assert_buffers_match(j, t)


def test_plain_collect_one_step_untamed():
    """One step of a random (untamed) actor: the per-step math contract at
    full steering (tests/test_ops.py:84)."""
    j, t = run_both(1, tame=False)
    assert_buffers_match(j, t)


def test_step_math_primitives_match_jax():
    """The polynomials, the bits -> uniform map and Box-Muller: the same
    float32 operations in both packages."""
    x = np.linspace(-1.0, 1.0, 20001, dtype=np.float32)
    np.testing.assert_allclose(t_step_math.acos(torch.tensor(x)).numpy(),
                               np.asarray(j_step_math.acos(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    th = np.linspace(-np.pi, np.pi, 20001, dtype=np.float32)
    for name in ("sin_pi", "cos_pi"):
        np.testing.assert_allclose(
            getattr(t_step_math, name)(torch.tensor(th)).numpy(),
            np.asarray(getattr(j_step_math, name)(jnp.asarray(th))),
            rtol=0, atol=1e-6, err_msg=name)
    bits = np.random.default_rng(0).integers(
        -2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    u = t_step_math.bits_to_uniform(torch.tensor(bits)).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(j_step_math.bits_to_uniform(jnp.asarray(bits))))
    assert u.min() >= 0.0 and u.max() < 1.0
    z_t = t_step_math.box_muller(torch.tensor(u[:2048]), torch.tensor(u[2048:]))
    z_j = j_step_math.box_muller(jnp.asarray(u[:2048]), jnp.asarray(u[2048:]))
    for a, b in zip(z_t, z_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_affine_compose_matches_jax():
    """The (4, obs) actor operator in full float32 (HIGHEST precision in
    JAX): products of width 50 in another order, 1e-6 relative."""
    ts, _ = j_make_mappo(
        JMAPPOConfig(num_parallel=8, buffer_len=4, batch_size=4,
                     num_total=32),
        j_make_env(JEnvParams(num_parallel=8), JTriangleInit(num_parallel=8),
                   None), JNormalizerConfig(), JScalerConfig()
    ).init(jax.random.PRNGKey(1))
    a_j, c_j = j_affine_compose(ts.actor)
    actor, _ = from_jax_params(jax.tree.map(np.asarray, (ts.actor, ts.critic)))
    a_t, c_t = fc._affine_compose(actor)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6,
                               atol=1e-7)


def test_row_state_round_trip_and_layout():
    """env_state_to_rows / rows_to_env_state invert each other and lay the
    rows out exactly as the JAX package's RowState."""
    j_env = j_make_env(JEnvParams(num_parallel=64),
                       JTriangleInit(num_parallel=64), None)
    s0 = j_env.init(jax.random.PRNGKey(2))
    s0 = s0._replace(step_num=jnp.arange(64, dtype=jnp.int32) % 7,
                     terminates=jnp.arange(64) % 3 == 0)
    state = EnvState(*(torch.tensor(np.asarray(x)) for x in
                       (s0.states, s0.obstacles, s0.target, s0.step_num,
                        s0.terminates)), EpisodeStats.zeros("cpu"),
                     make_generator(0))
    rows = fc.env_state_to_rows(state)
    for got, want in zip(rows.fields(), j_env_state_to_rows(s0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = fc.rows_to_env_state(rows, make_generator(0))
    for name in ("states", "obstacles", "target", "step_num", "terminates"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name


def test_cpu_routing_runs_plain_version_and_launches_nothing():
    """On CPU tensors the wrapper runs the plain version — on the given
    uniforms, or on uniforms drawn from a generator seeded with ``seed`` —
    and the kernel's launch counter does not move."""
    t, p = 5, 16
    ep = EnvParams(num_parallel=p, episode_len=3)
    ic = TriangleInitConfig(num_parallel=p)
    sm = t_step_math.StepMath(ep, ic, NormalizerConfig(), ScalerConfig())
    from marlnav_tpu_torch.env import make_env

    state = make_env(ep, ic, "cpu").init(make_generator(1))
    rows = fc.env_state_to_rows(state)
    g = torch.Generator().manual_seed(2)
    a_comp, c_comp = torch.randn(4, 12, generator=g), torch.randn(4, generator=g)
    before = fc.fused_collect_rows.launches
    out = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, t)
    uniforms = torch.rand((t, sm.n_draws, p), generator=make_generator(9))
    ref = fc.collect_rows_reference(sm, rows, a_comp, c_comp, uniforms)
    for name in ("obs", "actions", "log_probs", "rewards", "done", "stats"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert out.done[2].all() and int(out.stats[0]) == p  # truncation fired
    assert fc.fused_collect_rows.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fc.fused_collect_rows(sm, fc.RowState(*(x.to("meta") for x in
                                                rows.fields())),
                              a_comp, c_comp, 9, t)


# Intrinsics that compute something other than the IEEE float32 operation
# the plain version performs (approximate or fused), and the flag that
# turns them on everywhere.
_FAST_MATH = re.compile(
    r"\b(__fdividef|__expf|__exp10f|__logf|__log2f|__log10f|__sinf|__cosf"
    r"|__sincosf|__tanf|__powf|__fmaf_\w+|fmaf)\s*\(")
_STEP_SOURCES = ("step_math.cuh", "env_step.cuh", "fused_collect.cu",
                 "fused_rollout.cu")


def test_step_sources_keep_plain_arithmetic():
    """The env-step kernels equal their plain versions bit for bit only if
    every float operation rounds as PyTorch's does: the build keeps
    -fmad=false and no --use_fast_math, and the step sources call no
    fast-math intrinsic and no explicit fused multiply-add."""
    from marlnav_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in _build.NVCC_FLAGS, flags
    assert "fast_math" not in flags and "fast-math" not in flags, flags
    for name in _STEP_SOURCES:
        with open(os.path.join(_build.CSRC, name)) as fh:
            code = re.sub(r"//[^\n]*", "", fh.read())
        assert not _FAST_MATH.findall(code), (name, _FAST_MATH.findall(code))
    # the pattern does catch what it must
    assert _FAST_MATH.findall("y = __expf(x) + __fmaf_rn(a, b, c);")


@pytest.mark.parametrize("kernel", ["collect", "rollout"])
@pytest.mark.parametrize("num_envs", [1, 7, 1000, 1024, 16384])
def test_launch_geometry_gives_each_env_one_group_in_one_warp(kernel,
                                                              num_envs):
    """The rollout kernels' grid (fc.launch_geometry) steps env p on threads
    G p .. G p + G - 1 (env = thread // G, G the lanes an env: the templated
    instances' and every width the run-time instance has, in blocks of 128,
    64 or 32 threads): every env gets exactly one group of G lanes, the
    groups past P are fewer than a block's, and no group crosses a warp or
    a block."""
    from marlnav_tpu_torch.ops import fused_rollout as fr

    widths = {"collect": (fc.COLLECT_LANES, *fc.COLLECT_RT_LANES),
              "rollout": (fr.ROLLOUT_LANES, *fr.ROLLOUT_RT_LANES)}[kernel]
    for lanes in widths:
        for block in (fc.BLOCK_THREADS, 64, 32):
            blocks, threads = fc.launch_geometry(num_envs, lanes, block)
            assert 32 % lanes == 0 and threads % 32 == 0
            assert threads <= 256  # kMaxBlockThreads in ops/csrc/env_step.cuh
            tid = np.arange(blocks * threads)
            env = tid // lanes
            counts = np.bincount(env[env < num_envs], minlength=num_envs)
            assert counts.shape == (num_envs,) and (counts == lanes).all()
            assert (env >= num_envs).sum() < threads
            # each group's lanes share one warp
            first = np.arange(0, blocks * threads, lanes)
            assert (first // 32 == (first + lanes - 1) // 32).all()


def _widths(kernel):
    from marlnav_tpu_torch.ops import fused_rollout as fr

    return {"collect": fc.COLLECT_RT_LANES,
            "rollout": fr.ROLLOUT_RT_LANES}[kernel]


@pytest.mark.parametrize("kernel", ["collect", "rollout"])
@pytest.mark.parametrize("num_envs", [1, 7, 1000, 1024, 2048, 4096, 8192,
                                      16384, 100_000])
def test_rt_lanes_picks_an_instance_by_its_rule(kernel, num_envs):
    """fc.rt_lanes, at every (P, O) the card tests and times use: a width
    the run-time instance has; the widest at most the least power of two
    >= O + 3 whose grid holds at most RT_WARPS warps (half for 32 lanes),
    else the narrowest; no wider at more envs, no narrower at more
    obstacles."""
    widths = _widths(kernel)
    picks = []
    for o in (9, 13, 14, 17, 29, 30, 32, 655, 1205, 3223):
        pick = fc.rt_lanes(widths, num_envs, o)
        assert pick in widths
        useful = 1
        while useful < o + 3:
            useful *= 2
        fits = [w for w in widths if w <= useful and num_envs * w <= 32 * (
            fc.RT_WARPS // 2 if w == 32 else fc.RT_WARPS)]
        assert pick == (max(fits) if fits else min(widths)), o
        assert fc.rt_lanes(widths, 2 * num_envs, o) <= pick
        picks.append(pick)
    assert picks == sorted(picks)
    # the picks the card times: the collect at P 1024, the rollout at 16384
    if (kernel, num_envs) == ("collect", 1024):
        assert picks[:4] == [16, 16, 32, 32]
    if (kernel, num_envs) == ("rollout", 16384):
        assert set(picks) == {4}


def _rt_smem(heads=True, static=0):
    """ops/csrc/env_step.cuh rt_smem_floats in bytes, as the C
    marlnav_*_rt_smem returns it (-1 past 232,448 bytes with the kernel's
    ``static`` bytes: the collect's episode counters take 96); ``heads``
    False gives the layout before the actor heads had their slots."""
    def rt_smem(o, noisy, threads, lanes):
        f = 6 + 2 * o
        n = 3 * f + 2 * o + 6 + 2 * o + (9 if noisy else 0) + (12 if heads
                                                               else 0)
        nbytes = 4 * (4 * f + 4 + threads // lanes * ((n + 1) & ~1))
        return -1 if nbytes + static > 232448 else nbytes
    return rt_smem


@pytest.mark.parametrize("kernel", ["collect", "rollout"])
@pytest.mark.parametrize("noisy", [False, True])
def test_launch_shape_takes_every_obstacle_count_it_took(kernel, noisy):
    """fc.launch_shape with the kernels' shared-memory rule: the templated
    instances (O <= 8) keep their lanes and 128 threads and refuse another
    width; past them a forced width stays or raises; the chooser's pick
    widens where its groups do not fit, so every obstacle count that fit
    the run-time instance at 8 (collect) or 4 (rollout) lanes before the
    actor heads took shared memory still launches, at P 1 to 16384; past
    the widest width's limit it raises the ValueError that names the shared
    memory."""
    import types

    widths, templated = _widths(kernel), {"collect": 8, "rollout": 4}[kernel]
    rt_smem = _rt_smem(static=96 if kernel == "collect" else 0)
    before = _rt_smem(heads=False)

    def shape(o, p, lanes=None):
        sm = types.SimpleNamespace(o=o, noisy=noisy)
        return fc.launch_shape(kernel, sm, p, 8, rt_smem, templated, widths,
                               lanes)

    assert shape(3, 1024) == (templated, fc.BLOCK_THREADS)
    with pytest.raises(ValueError, match="templated"):
        shape(3, 1024, 16)
    with pytest.raises(ValueError, match="no run-time instance"):
        shape(17, 1024, 2)
    assert shape(17, 1024, widths[0]) == (widths[0], fc.BLOCK_THREADS)
    most = max(o for o in range(9, 1300) if before(o, noisy, 32, templated)
               >= 0)
    assert most == {"collect": 1207, "rollout": 656}[kernel] + (not noisy)
    for o in range(9, most + 1):
        for p in (1, 1024, 16384):
            lanes, threads = shape(o, p)
            assert lanes >= fc.rt_lanes(widths, p, o)
            assert rt_smem(o, noisy, threads, lanes) >= 0
    last = max(o for o in range(9, 4000) if rt_smem(o, noisy, 32, 32) >= 0)
    assert shape(last, 16384) == (32, 32)
    with pytest.raises(ValueError, match="shared memory"):
        shape(last + 1, 1)
    narrowest = max(o for o in range(9, 1300)
                    if rt_smem(o, noisy, 32, widths[0]) >= 0)
    with pytest.raises(ValueError, match="shared memory"):
        shape(narrowest + 1, 1, widths[0])  # a forced width does not widen
