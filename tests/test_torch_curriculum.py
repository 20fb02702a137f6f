"""The port's curriculum programs (``marlnav_tpu_torch/scripts/``) and its
reader of the JAX programs' state pickles (``utils/jax_state.py``)
against the JAX package, its saved states and its recorded runs.

Inputs come from the files in ``docs/`` (state pickles, actors, stage
records) and from numpy seeds; every output goes to ``tmp_path``.  Where a
trained policy is involved (the radius-30 states: the variance head's
bias near -12.4, a policy variance near 4e-6, rewards with a 5e5 bonus),
the tolerances are stated at each test.
"""

import ast
import copy
import dataclasses
import json
import os
import pickle
import re
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import Buffer as JBuffer
from marlnav_tpu.algo import make_mappo as j_make_mappo
from marlnav_tpu.config import EnvParams as JEnvParams
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu.config import NormalizerConfig as JNormalizerConfig
from marlnav_tpu.config import ScalerConfig as JScalerConfig
from marlnav_tpu.config import TriangleInitConfig as JTriangleInit
from marlnav_tpu.diagnostics.animation import \
    load_actor_weights as j_load_actor_weights
from marlnav_tpu.diagnostics.trajectory import \
    rollout_trajectory as j_rollout_trajectory
from marlnav_tpu.env import make_env as j_make_env
from marlnav_tpu.models import actor_apply
from marlnav_tpu.ops import make_fused_rollout as j_make_fused_rollout
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                      NormalizerConfig, ScalerConfig,
                                      TriangleInitConfig)
from marlnav_tpu_torch.diagnostics.animation import load_actor_weights
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import fused_rollout as fr
from marlnav_tpu_torch.ops.fused_collect import RowState, make_fused_collect
from marlnav_tpu_torch.scripts import curriculum as cur
from marlnav_tpu_torch.scripts import render_curriculum as rcur
from marlnav_tpu_torch.scripts import sweep as swp
from marlnav_tpu_torch.utils import jax_state
from test_torch_fused_collect import noise_per_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
STATE = os.path.join(DOCS, "curriculum_r5s42_state.pkl")
ACTOR31 = os.path.join(DOCS, "curriculum_r5s42_actor_stage31.npz")
STATES = sorted(f for f in os.listdir(DOCS) if re.fullmatch(
    r"curriculum_.*_state.*\.pkl", f))
# H42's stage constants (docs/curriculum_r5.md:255-268): radius 30,
# episode_len 400, group shaping 5e4, the 5e5 target bonus.
EP_R30 = dict(risk_factor=250.0, target_factor=500_000.0, target_radius=30.0,
              group_soft_factor=50_000.0, episode_len=400,
              staggered_resets=True)


@pytest.fixture(scope="module")
def jax_snap():
    """The seed-42 radius-30 state as JAX's own unpickling reads it (the
    JAX package imported)."""
    return _jax_unpickle(STATE)


def _jax_unpickle(path):
    import marlnav_tpu.algo.mappo  # noqa: F401  (the pickle's classes)
    import marlnav_tpu.ops.fused_rollout  # noqa: F401
    import optax  # noqa: F401

    with open(path, "rb") as fh:
        return pickle.load(fh)


def _layers(tree):
    return {name: getattr(tree, name) for name in tree._fields}


def _assert_network(module, tree, exact=True, **tol):
    """``module``'s parameters equal the JAX tree's (``w`` transposed)."""
    got = {n: m for n, m in module.named_children()}
    for name, dense in _layers(tree).items():
        for param, want in ((got[name].weight, np.asarray(dense.w).T),
                            (got[name].bias, np.asarray(dense.b))):
            have = param.detach().cpu().numpy()
            if exact:
                np.testing.assert_array_equal(have, want, err_msg=name)
            else:
                np.testing.assert_allclose(have, want, err_msg=name, **tol)


def _assert_adam(opt, module, adam, exact=True, **tol):
    """``opt``'s moments and step equal optax's ``ScaleByAdamState``."""
    got = {n: m for n, m in module.named_children()}
    for name in _layers(adam.mu):
        for leaf, param in (("w", got[name].weight), ("b", got[name].bias)):
            st = opt.state[param]
            assert float(st["step"]) == float(np.asarray(adam.count))
            for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                want = np.asarray(getattr(getattr(tree, name), leaf))
                want = want.T if leaf == "w" else want
                # The parameter's own layout (the fused Adam on the card
                # takes no other).
                assert st[key].stride() == param.stride(), (name, key)
                have = st[key].cpu().numpy()
                if exact:
                    np.testing.assert_array_equal(have, want,
                                                  err_msg=f"{name} {key}")
                else:
                    np.testing.assert_allclose(have, want, **tol,
                                               err_msg=f"{name} {key}")


# ----------------------------------------------------------------------
# (a) The JAX pickles, without the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", STATES)
def test_jax_state_equals_jax_unpickling(name):
    """Every state pickle in docs/: ``load_jax_state`` (the restricted
    unpickler, no JAX package) gives exactly what JAX's own unpickling
    holds, after the transposes: weights, Adam moments and count, rows
    and the schedule scalars."""
    path = os.path.join(DOCS, name)
    snap = _jax_unpickle(path)
    ts, rows, schedule = jax_state.load_jax_state(path, "cpu")
    for module, opt, tree, chain in (
            (ts.actor, ts.actor_opt, snap["ts"].actor, snap["ts"].actor_opt),
            (ts.critic, ts.critic_opt, snap["ts"].critic,
             snap["ts"].critic_opt)):
        _assert_network(module, tree)
        _assert_adam(opt, module, chain[0])
        assert opt.param_groups[0]["betas"] == (0.9, 0.999)
        assert opt.param_groups[0]["eps"] == 1e-8
    for field, want in zip(snap["rows"]._fields, snap["rows"]):
        np.testing.assert_array_equal(getattr(rows, field).numpy(),
                                      np.asarray(want), err_msg=field)
    assert schedule == {k: snap[k] for k in jax_state.SCHEDULE_KEYS
                        if k in snap}


def test_jax_state_refuses_other_globals(tmp_path):
    """The unpickler resolves only the state's classes and numpy's
    reconstructors: any other global is refused by name, before it is
    called."""
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"ts": os.getcwd, "rows": None}, fh)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        jax_state.read_jax_pickle(str(path))


def test_jax_state_reads_numpy1_names():
    """numpy 2 writes its reconstructors under ``numpy._core``; under
    numpy 1 (which has no ``numpy._core``) they are read from
    ``numpy.core``; numpy globals other than the reconstructors are
    refused."""
    for module in ("numpy._core.multiarray", "numpy.core.multiarray"):
        assert jax_state.numpy_module(module, "_reconstruct", 1) == \
            "numpy.core.multiarray"
        assert jax_state.numpy_module(module, "_reconstruct", 2) == module
    assert jax_state.numpy_module("numpy", "dtype", 1) == "numpy"
    assert jax_state.numpy_module("numpy._core.multiarray", "scalar", 1) \
        == "numpy.core.multiarray"
    assert jax_state.numpy_module("numpy", "load", 2) is None
    assert jax_state.numpy_module("numpy.lib.npyio", "load", 1) is None


# ----------------------------------------------------------------------
# (b) One actor and one critic phase from the state
# ----------------------------------------------------------------------

P_B, T_B = 64, 20


def test_phases_from_the_state_match_jax(jax_snap):
    """The state sliced to 64 envs; one T-20 buffer collected (the port's
    collect on numpy-injected uniforms) and fed to JAX's XLA-route
    ``train_actor`` / ``train_critic`` and to the port's autograd route,
    10 epochs each at full batch, from the converted state (Adam at step
    174,000 on both sides).

    Tolerances.  The critic's first loss (one forward from the converted
    network) agrees within test_torch_mappo.py's rtol 1e-4 / atol 1e-5.
    The actor's cannot, nor can anything after: the policy's std is ~2e-3,
    so a float32 action carries its offset from the mean to ~3e-5 and the
    ratios (1 within ~1e-4), times advantages carrying the 5e5 bonus, are
    set by float32 rounding.  The actor's first loss, a mean of ratio x
    advantage over 3,840 rows, agrees within 2e-3 relative (rounding:
    5e-4); each framework's gradients lie ~1e-3 of their largest
    magnitude from float64 ones (chip_smoke.py phase 21 (c) measures the
    kernel's and the plain version's); and one Adam step moves the mean
    by a fraction of a std, so the next epochs' clip edges differ between
    two float32 runs.  After the 10 epochs the weights agree within atol
    1e-4 (a third of one Adam step at lr 3e-4; rounding parts them by
    <= 5e-5) and the Adam moments within 10% of each leaf's largest
    magnitude (rounding: up to 6% for the variance head's, whose gradient
    is the difference of two terms of size 1/var ~ 2.5e5, and <= 1.5%
    elsewhere).  A wrong step count, moment or
    transpose in the conversion moves weights by whole steps and moments
    by their own size."""
    ts, rows, _ = jax_state.load_jax_state(STATE, "cpu")
    rows = RowState(*(x[..., :P_B].contiguous() for x in rows.fields()))
    kw = dict(num_parallel=P_B, buffer_len=T_B, batch_size=T_B,
              num_epochs=10, num_total=T_B * P_B, lr=3e-4, gamma=0.99,
              epsilon=0.2, ent_const=5e-4, use_gae=True, faithful=False)
    cfg = cur.build_cfg(P_B, T_B, ent_const=5e-4)
    ep, icfg = EnvParams(num_parallel=P_B, **EP_R30), TriangleInitConfig(
        num_parallel=P_B, num_obstacles=3)
    noise = np.random.default_rng(3).uniform(
        size=(T_B, 12, P_B)).astype(np.float32)
    _, buf, _ = make_fused_collect(cfg, ep, icfg, NormalizerConfig(),
                                   ScalerConfig())(ts, rows, 0,
                                                   torch.tensor(noise))
    jb = JBuffer(**{f.name: jnp.asarray(getattr(buf, f.name).numpy())
                    for f in dataclasses.fields(buf)})

    j_env = j_make_env(JEnvParams(num_parallel=P_B, **EP_R30), JTriangleInit(
        num_parallel=P_B, num_obstacles=3), None)
    j_mappo = j_make_mappo(JMAPPOConfig(**kw), j_env, JNormalizerConfig(),
                           JScalerConfig())
    j_ts = jax.tree.map(jnp.asarray, jax_snap["ts"])
    j_ts, j_al = jax.jit(j_mappo.train_actor)(j_ts, jb)
    j_ts, j_cl = jax.jit(j_mappo.train_critic)(j_ts, jb)

    from marlnav_tpu_torch.algo import make_mappo

    mappo = make_mappo(MAPPOConfig(**kw), make_env(ep, icfg, "cpu"),
                       NormalizerConfig(), ScalerConfig())
    ts, t_al = mappo.train_actor(ts, buf)
    ts, t_cl = mappo.train_critic(ts, buf)
    np.testing.assert_allclose(float(t_cl[0]), float(j_cl[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(t_al[0]), float(j_al[0]), rtol=2e-3)
    for module, opt, tree, chain in (
            (ts.actor, ts.actor_opt, j_ts.actor, j_ts.actor_opt),
            (ts.critic, ts.critic_opt, j_ts.critic, j_ts.critic_opt)):
        _assert_network(module, jax.tree.map(np.asarray, tree), False,
                        rtol=0.0, atol=1e-4)
        adam = jax.tree.map(np.asarray, chain[0])
        got = dict(module.named_children())
        for name in _layers(adam.mu):
            for leaf, param in (("w", got[name].weight),
                                ("b", got[name].bias)):
                assert float(opt.state[param]["step"]) == 174_010.0
                for key, tree_ in (("exp_avg", adam.mu),
                                   ("exp_avg_sq", adam.nu)):
                    want = getattr(getattr(tree_, name), leaf)
                    want = want.T if leaf == "w" else want
                    np.testing.assert_allclose(
                        opt.state[param][key].numpy(), want, rtol=0.0,
                        atol=0.1 * np.abs(want).max(),
                        err_msg=f"{name}.{leaf} {key}")
    # The trained regime: the phase moved the weights by whole steps.
    w0 = np.asarray(jax_snap["ts"].actor.fc_mu.w).T
    assert np.abs(ts.actor.fc_mu.weight.detach().numpy() - w0).max() > 3e-4


# ----------------------------------------------------------------------
# (c) Mean-eval from the pickled rows
# ----------------------------------------------------------------------

T_C = 30


def test_mean_eval_from_the_state_matches_jax(jax_snap):
    """A policy-mean rollout of the trained actor from the first 1024
    pickled envs at H42's constants, the same uniforms into JAX's rollout
    kernel (interpret mode) and the port's plain version.  Step-1 rewards
    agree within 1e-5 relative, and within 1e-5 of the group shaping's
    scale (5e4, atol 0.5) where the reward, a difference of two shaping
    potentials of that scale, is small: a one-ulp difference in a position
    (~6e-5 at 1e3) moves it by ~1e-2.  The count
    of bonus steps (reward > 2.5e5, ``mean_eval``'s rule) agrees within 2
    of ~10: a policy-mean trajectory passes ulp differences of the two
    frameworks' tanh/log through the dynamics each step, and an env whose
    agents cross the disk's edge on a step boundary can reach one step
    apart, so a count may move by an env or two, not more."""
    p = 1024
    rows = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[..., :p]),
                        jax_snap["rows"])
    j_ep = JEnvParams(num_parallel=p, **EP_R30)
    j_ic = JTriangleInit(num_parallel=p, num_obstacles=3)
    noise = np.random.default_rng(11).uniform(
        size=(T_C, 12, 8, p // 8)).astype(np.float32)
    j_roll = j_make_fused_rollout(j_ep, j_ic, JNormalizerConfig(),
                                  JScalerConfig(), T_C,
                                  deterministic_actions=True,
                                  interpret=True, noise_input=True)
    _, j_rew = j_roll(rows, jax.tree.map(jnp.asarray, jax_snap["ts"].actor),
                      0, noise=jnp.asarray(noise))
    j_rew = np.asarray(j_rew)

    ts, t_rows, _ = jax_state.load_jax_state(STATE, "cpu")
    t_rows = RowState(*(x[..., :p].contiguous() for x in t_rows.fields()))
    roll = fr.make_fused_rollout(EnvParams(num_parallel=p, **EP_R30),
                                 TriangleInitConfig(num_parallel=p,
                                                    num_obstacles=3),
                                 NormalizerConfig(), ScalerConfig(), T_C,
                                 deterministic_actions=True, device="cpu")
    _, t_rew = roll(t_rows, ts.actor, 0,
                    noise=torch.tensor(noise_per_env(noise)))
    t_rew = t_rew.numpy()
    np.testing.assert_allclose(t_rew[0], j_rew[0], rtol=1e-5,
                               atol=1e-5 * 50_000.0)
    j_count, t_count = int((j_rew > 2.5e5).sum()), int((t_rew > 2.5e5).sum())
    assert j_count > 0
    assert abs(t_count - j_count) <= 2, (t_count, j_count)


# ----------------------------------------------------------------------
# (d) The schedule against the recorded runs
# ----------------------------------------------------------------------

# docs/curriculum_r5.md:255-268: the base flags of every round-5 run, and
# each run's own.  S2's record needs the S42 flags' --coarse-threshold
# 0.01 (its stage-6 share, 0.81%, annealed).
BASE = ("--mode radius-noise-adaptive --repeats-per-stage 600 --group-soft "
        "50000 --episode-len-small 400 --mean-eval --consolidate 3")
RUNS = {
    "r5s42": "--seed 42 --max-stages 60 --coarse-threshold 0.01",
    "r5s2": "--seed 2 --max-stages 60 --coarse-threshold 0.01",
    "r5s42b": "--seed 42 --max-stages 51 --coarse-threshold 0.01 "
              "--fine-threshold 0.01 --consolidate 20 --resume-state "
              "docs/curriculum_r5s42_state.pkl",
    "r5h": "--seed 23 --max-stages 25 --coarse-threshold 0.01 "
           "--fine-threshold 0.01 --resume-state "
           "docs/curriculum_r4f3_state.pkl",
    "r5s5c": "--seed 5 --max-stages 78 --coarse-threshold 0.01 "
             "--restore-reheat 1.0 --resume-state "
             "docs/curriculum_r5s5_state.pkl",
}
SOLVED = {"r5s42": 31, "r5s2": 52, "r5h": 18, "r5s42b": None, "r5s5c": None}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_schedule_replays_recorded_runs(run):
    """Each recorded stage's counts fed to the port's gate reproduce every
    recorded radius, ent_const, episode_len, target_factor and restored
    entry, and the solve stage (or the end at --max-stages).  Resumed runs
    start from their pickle's schedule scalars."""
    ns = cur.build_parser().parse_args(shlex.split(f"{BASE} {RUNS[run]}"))
    with open(os.path.join(DOCS, f"curriculum_{run}_radius_noise_adaptive"
                           ".json")) as fh:
        recs = json.load(fh)
    s = cur.Schedule()
    if ns.resume_state:
        s = cur.resumed_schedule(jax_state.read_jax_pickle(
            os.path.join(ROOT, ns.resume_state)))
    seen, solved = [], None
    while s.radius >= 30.0 and s.stage < ns.max_stages:
        s = dataclasses.replace(s, stage=s.stage + 1)
        rec = recs[len(seen)]
        tf, ep_len, _ = cur.stage_params(s.radius, ns)
        assert (rec["stage"], rec["radius"], rec["ent_const"],
                rec["target_factor"], rec["episode_len"]) == (
            s.stage, s.radius, s.ent, tf, ep_len), rec
        gate = cur.noise_adaptive_gate(s, rec["tar"], rec["col"],
                                       rec["trunc"], ns)
        assert gate.restored == rec.get("restored") or (
            gate.restored is not None and "reheat" not in rec["restored"]
            and {k: gate.restored[k] for k in rec["restored"]}
            == rec["restored"]), (rec, gate.restored)
        seen.append(rec["stage"])
        s = gate.schedule
        if gate.solved:
            solved = s.stage
            break
    assert seen == [r["stage"] for r in recs]
    assert solved == SOLVED[run]


def test_schedule_share_is_recomputed_from_counts():
    """The gate reads the counts, not the record's 4-digit share: at a
    share of 0.0100004 the 1% gate clears, though it rounds to 0.0100."""
    ns = cur.build_parser().parse_args(shlex.split(
        f"{BASE} --coarse-threshold 0.01 --fine-threshold 0.01"))
    s = cur.Schedule(radius=100, ent=1e-3, stage=5)
    gate = cur.noise_adaptive_gate(s, 100_004, 9_900_000 - 4, 0, ns)
    assert round(cur.share_of(100_004, 9_900_000 - 4, 0), 4) == 0.01
    assert gate.cleared and gate.schedule.radius == 92
    assert gate.var_shift == -0.5 and gate.schedule.ent == 5e-4


# ----------------------------------------------------------------------
# (e) - (g) Files, snapshots and restores
# ----------------------------------------------------------------------

def test_actor_npz_round_trip_with_jax(tmp_path):
    """An actor the port writes (the curriculum's per-stage file) read by
    JAX's ``load_actor_weights`` gives the same forward output, and a
    JAX-written actor (docs/, the JAX program's file) read by the port's
    gives JAX's output."""
    ts, _, _ = jax_state.load_jax_state(STATE, "cpu")
    path = str(tmp_path / "a_actor_stage1.npz")
    cur.save_actor(path, ts.actor)
    obs = np.random.default_rng(2).normal(size=(64, 3, 12)).astype(
        np.float32)
    for j_file, t_actor in ((path, ts.actor),
                            (ACTOR31, load_actor_weights(ACTOR31, 12))):
        j_mean, j_var = actor_apply(j_load_actor_weights(j_file, 12),
                                    jnp.asarray(obs))
        t_mean, t_var = t_actor(torch.tensor(obs))
        np.testing.assert_allclose(t_mean.detach().numpy(),
                                   np.asarray(j_mean), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t_var.detach().numpy(), np.asarray(j_var),
                                   rtol=1e-5, atol=1e-12)


def _tiny_state(seed=0, p=8):
    """A fresh port train state with Adam state (one actor step taken)."""
    cfg = cur.build_cfg(p, 4)
    ep = EnvParams(num_parallel=p, staggered_resets=True)
    icfg = TriangleInitConfig(num_parallel=p, num_obstacles=3)
    mappo, collect = cur.stage_functions(cfg, ep, icfg, torch.device("cpu"))
    ts, rows = cur._start(mappo, seed, "cpu")
    rows, buf, _ = collect(ts, rows, 5)
    mappo.train_actor(ts, buf)
    mappo.train_critic(ts, buf)
    return ts, rows


def test_save_and_resume_bit_for_bit(tmp_path):
    """The port's own state file restores every tensor (networks, Adam
    moments and steps, rows) and the schedule scalars bit for bit."""
    ts, rows = _tiny_state()
    path = str(tmp_path / "state.pt")
    cur.save_state(path, ts, rows, radius=92, ent=2.5e-3, gr=1234, stage=7,
                   share=0.0123)
    ts2, rows2, sched = cur.load_state(path, "cpu")
    assert sched == {"radius": 92, "ent": 2.5e-3, "gr": 1234, "stage": 7,
                     "share": 0.0123}
    for a, b in ((ts.actor, ts2.actor), (ts.critic, ts2.critic)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    for a, b in ((ts.actor_opt, ts2.actor_opt),
                 (ts.critic_opt, ts2.critic_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert all(torch.equal(x, y) for x, y in zip(rows.fields(),
                                                 rows2.fields()))
    # The file is the port's, not a pickle of the JAX programs'.
    with pytest.raises(pickle.UnpicklingError):
        jax_state.read_jax_pickle(path)


def test_restore_copies_into_the_live_tensors():
    """After a restore, the live actor, critic, Adam state and rows equal
    the snapshot's, through the very tensors a CUDA graph or a wrapper
    captured before (nothing is rebound); a restore that only rebinds
    names would leave those tensors at the drifted values."""
    ts, rows = _tiny_state()
    best = cur.Snapshot.take(ts, rows)
    held = [ts.actor.fc1.weight, ts.actor.fc_var.bias, ts.critic.fc2.weight,
            ts.actor_opt.state[ts.actor.fc1.weight]["exp_avg"], rows.px]
    want = [x.detach().clone() for x in held]
    # Drift: more training, a variance shift, moved rows.
    cfg = cur.build_cfg(8, 4)
    mappo, collect = cur.stage_functions(
        cfg, EnvParams(num_parallel=8, staggered_resets=True),
        TriangleInitConfig(num_parallel=8, num_obstacles=3),
        torch.device("cpu"))
    new_rows, buf, _ = collect(ts, rows, 9)
    mappo.train_actor(ts, buf)
    mappo.train_critic(ts, buf)
    cur.shift_variance(ts.actor, -0.5)
    rows.px.copy_(new_rows.px)
    assert not any(torch.equal(h, w) for h, w in zip(held, want))
    # A restore that rebinds: a new actor with the snapshot's weights.  The
    # train state's name now points at them, the held tensors do not.
    actor = copy.deepcopy(ts.actor)
    actor.load_state_dict(best.actor)
    rebound = dataclasses.replace(ts, actor=actor)
    assert torch.equal(rebound.actor.fc1.weight, want[0])
    assert not torch.equal(held[0], want[0])
    best.restore(ts, rows)
    assert all(torch.equal(h, w) for h, w in zip(held, want))
    assert held[0] is ts.actor.fc1.weight and held[4] is rows.px
    # The snapshot is its own copy: a reheat after the restore leaves it.
    cur.shift_variance(ts.actor, 1.0)
    assert torch.equal(best.actor["fc_var.bias"], want[1])


# ----------------------------------------------------------------------
# (h) The CLI
# ----------------------------------------------------------------------

P_H, T_H = 8, 8


@pytest.mark.parametrize("mode", ["radius-noise-adaptive", "radius-adaptive",
                                  "obstacles", "radius", "none"])
def test_cli_modes_on_the_cpu(mode, tmp_path, capsys):
    """Each mode through ``main`` on the CPU at P 8 / T 8, 4 repeats a
    stage: two stages of the adaptive modes (every gate cleared), the
    fixed modes' stages; the JSON lines, the JSON file, the per-stage
    actors (JAX layout) and the state file."""
    out = str(tmp_path / "runs" / "c")
    argv = ["--device", "cpu", "--mode", mode, "--repeats-per-stage", "4",
            "--max-stages", "2", "--out", out]
    if mode == "radius-noise-adaptive":
        argv += ["--mean-eval", "--save-state", str(tmp_path / "s.pt"),
                 "--coarse-threshold", "-1", "--fine-threshold", "-1"]
    result = cur.main(argv, p=P_H, t=T_H)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    suffix = mode.replace("-", "_") if "adaptive" in mode else mode
    with open(f"{out}_{suffix}.json") as fh:
        written = json.load(fh)
    if "adaptive" in mode:
        assert [r["stage"] for r in written] == [1, 2] == [
            r["stage"] for r in lines]
        for k in (1, 2):
            with np.load(f"{out}_actor_stage{k}.npz") as data:
                assert data["fc1.w"].shape == (12, 50)
    else:
        n = len(cur.stage_geometry(mode))
        assert len(written["stages"]) == n == len(lines)
    if mode == "radius-noise-adaptive":
        assert written[0]["radius"] == 300.0 and written[1]["radius"] == 255
        assert written[1]["ent_const"] == 0.005 and "mean_tar" in written[0]
        _, _, sched = cur.load_state(str(tmp_path / "s.pt"), "cpu")
        assert sched["stage"] == 2 and sched["gr"] == 8
        assert written == result


def test_cli_resume_and_restore(tmp_path, capsys):
    """A run resumed from the port's state file continues its stage count,
    and two collapsed stages (no share clears a gate of 2) restore the
    resumed state and retry at max(30, round(min(r / 0.92, best_r *
    0.96))), the reheat recorded."""
    state = str(tmp_path / "s.pt")
    cur.main(["--device", "cpu", "--mode", "radius-noise-adaptive",
              "--repeats-per-stage", "4", "--max-stages", "1", "--save-state",
              state, "--coarse-threshold", "-1", "--out",
              str(tmp_path / "a")], p=P_H, t=T_H)
    capsys.readouterr()
    hist = cur.main(["--device", "cpu", "--mode", "radius-noise-adaptive",
                     "--repeats-per-stage", "4", "--max-stages", "3",
                     "--resume-state", state, "--restore-reheat", "0.5",
                     "--coarse-threshold", "2", "--out",
                     str(tmp_path / "b")], p=P_H, t=T_H)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0]["resumed"]["stage"] == 1
    assert lines[0]["resumed"]["radius"] == 300.0
    assert [r["stage"] for r in hist] == [2, 3]
    assert [r["radius"] for r in hist] == [300.0, 300.0]
    assert hist[1]["restored"] == {"from_radius": 300.0, "retry_radius": 288,
                                   "reheat": 0.5}
    assert lines[-1] == {"restore": hist[1]["restored"]}


def test_cli_raises_without_a_card(tmp_path):
    """``python -m marlnav_tpu_torch.scripts.<name>`` runs on cuda by
    default and raises where there is none (this box)."""
    for name, extra in (("curriculum", ["--mode", "none"]),
                        ("render_curriculum", []),
                        ("sweep", ["--grid", "quick"])):
        proc = subprocess.run(
            [sys.executable, "-m", f"marlnav_tpu_torch.scripts.{name}",
             *extra, "--out", str(tmp_path / name)], cwd=ROOT,
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0, name
        assert "CUDA is not available" in proc.stderr, proc.stderr[-500:]


def _jax_flags(name):
    """``{flag: default}`` of ``scripts/<name>.py``'s argparse calls."""
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as fh:
        tree = ast.parse(fh.read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else False  # store_true
            flags[ast.literal_eval(node.args[0])] = default
    return flags


@pytest.mark.parametrize("name", ["curriculum", "render_curriculum", "sweep"])
def test_programs_take_every_flag_of_their_counterparts(name):
    """Every flag of ``scripts/<name>.py`` with its default, but ``--out``,
    whose default lies under ``runs/``; plus ``--device`` (cuda)."""
    jax_flags = _jax_flags(name)
    module = {"curriculum": cur, "render_curriculum": rcur,
              "sweep": swp}[name]
    parser = module.build_parser()
    port_flags = {a for act in parser._actions for a in act.option_strings}
    assert jax_flags and set(jax_flags) <= port_flags
    assert port_flags - set(jax_flags) == {"--device", "-h", "--help"}
    defaults = vars(parser.parse_args([]))
    for flag, default in jax_flags.items():
        if flag != "--out":
            assert defaults[flag[2:].replace("-", "_")] == default, flag
    assert defaults["device"] == "cuda"
    assert defaults["out"].startswith("runs/")
    assert defaults["out"][5:] == os.path.basename(jax_flags["--out"])


# ----------------------------------------------------------------------
# (i) The renderer's statistics, (j) the sweep
# ----------------------------------------------------------------------

def test_renderer_stats_match_jax_without_matplotlib(tmp_path, monkeypatch,
                                                     capsys):
    """The stage-31 actor at radius 30, episode_len 400, 1024 envs, 300
    sampled steps: the port's count of envs with a group reach against the
    JAX renderer's (its rollout and its reach rule).  The two packages draw
    different samples, so each count is binomial (n 1024, p near 0.1):
    they agree within 5 standard deviations of their difference,
    5 * sqrt(2 n p (1 - p)) with the pooled p.  With matplotlib blocked
    the statistics print first, then the run raises naming matplotlib."""
    steps, n = 300, 1024
    j_env = j_make_env(JEnvParams(num_parallel=n, risk_factor=250.0,
                                  target_radius=30.0, episode_len=400),
                       JTriangleInit(num_parallel=n, num_obstacles=3), None)
    j_traj = j_rollout_trajectory(
        j_env, steps, jax.random.PRNGKey(7),
        actor=j_load_actor_weights(ACTOR31, j_env.params.obs_size),
        normalizer_cfg=JNormalizerConfig(), scaler_cfg=JScalerConfig(),
        sample=True)
    j_stats = rcur.reach_stats(j_traj, 30.0)

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        rcur.main(["--device", "cpu", "--radius", "30", "--envs", str(n),
                   "--steps", str(steps), "--episode-len", "400",
                   "--weights", ACTOR31, "--out", str(tmp_path / "r.gif")])
    stats = json.loads(capsys.readouterr().out.splitlines()[0])
    assert stats["envs"] == n and stats["steps"] == steps
    got, want = stats["envs_with_group_reach"], j_stats[
        "envs_with_group_reach"]
    pooled = (got + want) / (2 * n)
    assert want > 0 and got > 0
    assert abs(got - want) <= 5 * np.sqrt(2 * n * pooled * (1 - pooled)), (
        got, want)
    assert not os.path.exists(tmp_path / "r.gif")


def test_sweep_quick_grid_on_the_cpu(tmp_path):
    """``--grid quick`` at P 8 / T 8, 4 repeats a cell, through
    ``train.train``: both cells scored on their last quarter, best share
    first, the JSON and the markdown table written."""
    out = str(tmp_path / "sw")
    cells = swp.main(["--device", "cpu", "--grid", "quick", "--repeats", "4",
                      "--out", out], p=P_H, t=T_H)
    assert sorted(c["risk_factor"] for c in cells) == [0.0, 250.0]
    assert [c["tar_share"] for c in cells] == sorted(
        (c["tar_share"] for c in cells), reverse=True)
    for c in cells:
        assert c["tar"] + c["col"] + c["trunc"] >= 0
        assert np.isfinite(c["mean_rew_last"])
    with open(out + ".json") as fh:
        assert json.load(fh) == {"repeats": 4, "cells": cells}
    with open(out + ".md") as fh:
        assert fh.read().count("\n| ") == 3
