"""Data-parallel training of the port (``--num-data``, ``--multihost``) on
the CPU, over gloo ranks.

(a) the plain route at 2 ranks (collect -> actor -> critic) equals the run
    without a mesh from the same seed, at tests/test_sharding.py:80-92's
    tolerances, in the faithful, fixed and GAE modes;
(b) the fused route (the kernels' plain versions) with injected noise,
    likewise, at tests/test_fused_collect.py:700-711's tolerances;
(c) the update phases at 2 ranks, on the autograd and the fused route,
    equal the JAX package's on its 8-device CPU mesh from the same
    parameters and numpy buffer;
(d) rank r's fused collect and sharded bench rollout equal one-process
    runs of its envs at seed + (r << 20), bit for bit, and an env count
    that does not split raises;
(e) the CLI: ``--num-data 2`` (only rank 0 writes), ``--multihost`` from
    the three coordination flags (one process, and two processes equal to
    ``--num-data 2``), and a checkpoint written at 2 ranks resuming at 2
    (bit for bit) and at 1.

The ranks of (a)-(d) run as one group (``test_torch_parallel.run_group``,
its own timeout); the CLI runs are subprocesses with timeouts.
"""

import dataclasses
import glob
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlnav_tpu_torch.algo.mappo import Buffer, TrainState, make_adam
from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                      NormalizerConfig, ScalerConfig,
                                      TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, Critic
from marlnav_tpu_torch.models.networks import flat_params, load_flat_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops.fused_rollout import make_fused_rollout
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator
from test_torch_parallel import ROOT, cpu_mesh, run_group

P, T, A, O, H = 16, 8, 3, 3, 16
OBS = 2 + 2 * O + 2 * (A - 1)
MODES = {"faithful": {}, "fixed": {"faithful": False},
         "gae": {"faithful": False, "use_gae": True}}
NORM, SCAL = NormalizerConfig(), ScalerConfig()
EP = EnvParams(num_parallel=P, num_agents=A, num_obstacles=O, episode_len=6)
ICFG = TriangleInitConfig(num_parallel=P, num_obstacles=O)


def config(mode="faithful", **kw):
    return MAPPOConfig(num_agents=A, num_parallel=P, obs_size=OBS,
                       hidden_size=H, buffer_len=T, batch_size=T,
                       num_epochs=2, num_total=T * P, **MODES[mode], **kw)


def weights(ts):
    return {name: flat_params(getattr(ts, name)) for name in
            ("actor", "critic")}


def plain_run(mode, mesh):
    """(a): collect -> actor -> critic on the plain route."""
    cfg = config(mode)
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    mappo = make_mappo(cfg, env, NORM, SCAL, mesh=mesh)
    g = make_generator(0)
    ts, es = mappo.init(g)
    es, buf, met = mappo.collect(ts, es, g)
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    return dict(mean_rew=met.mean_rew, returns=buf.returns, al=al, cl=cl,
                stats=[int(getattr(met.stats, f.name)) for f in
                       dataclasses.fields(met.stats)],
                states=es.states, weights=weights(ts))


def uniforms():
    n_draws = StepMath(EP, ICFG, NORM, SCAL).n_draws
    return torch.from_numpy(np.random.default_rng(5).random(
        (T, n_draws, P), dtype=np.float32))


def fused_run(mode, mesh):
    """(b): the fused collect and updates on injected uniforms."""
    cfg = config(mode, fused_updates=True)
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    mappo = make_mappo(cfg, env, NORM, SCAL, mesh=mesh)
    ts, es = mappo.init(make_generator(0))
    collect = fc.make_fused_collect(cfg, EP, ICFG, NORM, SCAL, mesh)
    rows, buf, met = collect(ts, fc.env_state_to_rows(es), 7, uniforms())
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    return dict(rows=rows.fields(), mean_rew=met.mean_rew,
                returns=buf.returns, al=al, cl=cl, weights=weights(ts))


def phases_run(mode, route, mesh, inputs):
    """(c): the update phases from the JAX package's parameters and a
    numpy buffer."""
    from marlnav_tpu_torch.parallel import shard_buffer

    cfg = config(mode, fused_updates=route == "fused")
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    mappo = make_mappo(cfg, env, NORM, SCAL, mesh=mesh)
    actor = load_flat_params(Actor(OBS, H, 2), inputs["actor"])
    critic = load_flat_params(Critic(OBS, A, H), inputs["critic"])
    ts = TrainState(actor, critic, make_adam(actor, cfg.lr),
                    make_adam(critic, cfg.lr))
    buf = Buffer(**{k: torch.from_numpy(v) for k, v in
                    inputs["buffer"].items()})
    if mesh is not None:
        buf = shard_buffer(buf, mesh, A)
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    return dict(al=al, cl=cl, weights=weights(ts))


def global_rows():
    env = make_env(EP, ICFG, "cpu")
    return fc.env_state_to_rows(env.init(make_generator(0)))


def columns(rows, rank, world=2):
    count = P // world
    return fc.RowState(*(x[:, rank * count:(rank + 1) * count].contiguous()
                         for x in rows.fields()))


def _ranks_training(rank, world, out_dir):
    mesh = cpu_mesh(rank, world)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    out = {("plain", m): plain_run(m, mesh) for m in MODES}
    out.update({("fused", m): fused_run(m, mesh) for m in MODES})
    for mode in ("faithful", "fixed"):
        for route in ("autograd", "fused"):
            out[("phases", mode, route)] = phases_run(mode, route, mesh,
                                                      inputs[mode])
    # (d) the collect kernel's function and the sharded rollout, no noise
    cfg = config()
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    ts, es = make_mappo(cfg, env, NORM, SCAL, mesh=mesh).init(
        make_generator(0))
    k = fc.make_fused_collect(cfg, EP, ICFG, NORM, SCAL, mesh).run_kernel(
        ts, fc.env_state_to_rows(es), 7)
    out["collect"] = [*k.rows.fields(), k.obs, k.actions, k.log_probs,
                      k.rewards, k.done, k.stats]
    from marlnav_tpu_torch.ops.sharded import make_sharded_fused_rollout

    roll = make_sharded_fused_rollout(EP, ICFG, NORM, SCAL, T, mesh)
    rows_g = global_rows()
    out["rollout"] = roll(rows_g, ts.actor, 9)
    raised = []
    odd = fc.RowState(*(x[:, :15].contiguous() for x in rows_g.fields()))
    for attempt in (lambda: roll(odd, ts.actor, 9),
                    lambda: make_env(dataclasses.replace(EP, num_parallel=15),
                                     dataclasses.replace(ICFG,
                                                         num_parallel=15),
                                     "cpu", mesh=mesh)):
        try:
            attempt()
        except ValueError as err:
            raised.append(str(err))
    out["raised"] = raised
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def rand_buffer(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(T, P, A, OBS)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(T, P, A, 2)).astype(np.float32),
        log_probs=rng.normal(-1.0, 0.5, size=(T, P * A)).astype(np.float32),
        values=rng.normal(size=(T, P, 1)).astype(np.float32),
        returns=rng.normal(size=(T, P)).astype(np.float32),
        done=rng.uniform(size=(T, P)) < 0.2)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The JAX package's initial parameters and a numpy buffer for (c),
    then the group of 2 ranks; returns its ranks' results and the
    inputs."""
    import jax

    from marlnav_tpu.algo import make_mappo as j_make_mappo
    from marlnav_tpu.config import EnvParams as JEnvParams
    from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
    from marlnav_tpu.config import NormalizerConfig as JNorm
    from marlnav_tpu.config import ScalerConfig as JScal
    from marlnav_tpu.config import TriangleInitConfig as JTri
    from marlnav_tpu.env import make_env as j_make_env

    out_dir = tmp_path_factory.mktemp("ranks")
    inputs = {}
    for i, mode in enumerate(("faithful", "fixed")):
        jcfg = JMAPPOConfig(**dataclasses.asdict(config(mode)))
        jenv = j_make_env(JEnvParams(**dataclasses.asdict(EP)),
                          JTri(**dataclasses.asdict(ICFG)), None)
        jm = j_make_mappo(jcfg, jenv, JNorm(), JScal())
        ts, _ = jm.init(jax.random.PRNGKey(i))
        flat = {name: {f"{k}.{leaf}": np.asarray(getattr(d, leaf))
                       for k, d in getattr(ts, name)._asdict().items()
                       for leaf in ("w", "b")}
                for name in ("actor", "critic")}
        inputs[mode] = dict(flat, buffer=rand_buffer(i), jax=(jm, ts))
    torch.save({m: {k: v for k, v in d.items() if k != "jax"}
                for m, d in inputs.items()},
               os.path.join(out_dir, "inputs.pt"))
    return run_group("test_torch_data_parallel", "_ranks_training", 2,
                     out_dir, timeout=240.0), inputs


def close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def close_weights(ranks_w, want_w, rtol, atol):
    for r_w in ranks_w:  # replicated: every rank holds the same weights
        for net in ("actor", "critic"):
            for key, v in want_w[net].items():
                close(r_w[net][key], v, rtol, atol, f"{net} {key}")


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_route_two_ranks_equal_one(group, mode):
    ranks = [r[("plain", mode)] for r in group[0]]
    want = plain_run(mode, None)
    for r in ranks:
        close(r["mean_rew"], want["mean_rew"], 1e-5, 0, "mean_rew")
        assert r["stats"] == want["stats"]
        close(r["al"], want["al"], 2e-4, 1e-5, "actor losses")
        close(r["cl"], want["cl"], 2e-4, 1e-5, "critic losses")
    close(torch.cat([r["returns"] for r in ranks], 1), want["returns"],
          1e-4, 1e-5, "returns")
    close(torch.cat([r["states"] for r in ranks]), want["states"], 1e-5,
          1e-3, "env states")
    close_weights([r["weights"] for r in ranks], want["weights"], 2e-4,
                  1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_route_two_ranks_equal_one(group, mode):
    ranks = [r[("fused", mode)] for r in group[0]]
    want = fused_run(mode, None)
    for i, x in enumerate(want["rows"]):
        close(torch.cat([r["rows"][i] for r in ranks], -1), x, 1e-5, 1e-3,
              f"rows field {i}")
    close(torch.cat([r["returns"] for r in ranks], 1), want["returns"],
          1e-4, 1e-3, "returns")
    for r in ranks:
        close(r["mean_rew"], want["mean_rew"], 1e-5, 0, "mean_rew")
        close(r["al"], want["al"], 1e-4, 1e-5, "actor losses")
        close(r["cl"], want["cl"], 1e-4, 1e-5, "critic losses")
    close_weights([r["weights"] for r in ranks], want["weights"], 1e-4,
                  1e-5)


@pytest.mark.parametrize("route", ["autograd", "fused"])
@pytest.mark.parametrize("mode", ["faithful", "fixed"])
def test_phases_match_jax_mesh(group, mode, route):
    """The JAX package's XLA update phases with the buffer and the train
    state sharded over its 8 CPU devices (tests/test_sharding.py:58-92)
    against the port's at 2 ranks, from the same parameters and buffer."""
    import jax

    from marlnav_tpu.algo import Buffer as JBuffer
    from marlnav_tpu.parallel import (buffer_shardings, make_mesh,
                                      shard_train_state)

    jm, ts = group[1][mode]["jax"]
    mesh = make_mesh()
    jbuf = jax.device_put(
        JBuffer(**{k: np.asarray(v) for k, v in
                   group[1][mode]["buffer"].items()}),
        buffer_shardings(mesh))
    ts = shard_train_state(ts, mesh)
    ts, al = jax.jit(jm.train_actor)(ts, jbuf)
    ts, cl = jax.jit(jm.train_critic)(ts, jbuf)
    ranks = [r[("phases", mode, route)] for r in group[0]]
    want_w = {name: {f"{k}.{leaf}": np.asarray(getattr(d, leaf))
                     for k, d in getattr(ts, name)._asdict().items()
                     for leaf in ("w", "b")}
              for name in ("actor", "critic")}
    for r in ranks:
        close(r["al"], al, 2e-4, 1e-5, "actor losses")
        close(r["cl"], cl, 2e-4, 1e-5, "critic losses")
    close_weights([r["weights"] for r in ranks], want_w, 2e-4, 1e-5)


def test_collect_seed_is_offset_by_rank(group):
    """Rank r's collect (no noise) equals a one-process collect of its
    envs at seed + (r << 20), bit for bit; rank 1's stream is not rank
    0's."""
    cfg = config()
    env = make_env(EP, ICFG, "cpu")
    ts, _ = make_mappo(cfg, env, NORM, SCAL).init(make_generator(0))
    one = fc.make_fused_collect(cfg, EP, ICFG, NORM, SCAL)
    rows_g = global_rows()
    for rank, r in enumerate(group[0]):
        assert fc.shard_seed(7, rank) == 7 + (rank << 20)
        k = one.run_kernel(ts, columns(rows_g, rank), fc.shard_seed(7, rank))
        want = [*k.rows.fields(), k.obs, k.actions, k.log_probs, k.rewards,
                k.done, k.stats]
        for got, x in zip(r["collect"], want):
            assert torch.equal(got, x)
    other = one.run_kernel(ts, columns(rows_g, 1), 7)
    assert not torch.equal(group[0][1]["collect"][10], other.actions)


def test_sharded_rollout_is_offset_by_rank(group):
    """make_sharded_fused_rollout: rank r's final rows and rewards equal a
    one-process rollout of its envs at seed + (r << 20), bit for bit; an
    env count that does not split over the ranks raises, naming both."""
    cfg = config()
    env = make_env(EP, ICFG, "cpu")
    ts, _ = make_mappo(cfg, env, NORM, SCAL).init(make_generator(0))
    roll = make_fused_rollout(EP, ICFG, NORM, SCAL, T, device="cpu")
    rows_g = global_rows()
    for rank, r in enumerate(group[0]):
        rows, rewards = roll(columns(rows_g, rank), ts.actor,
                             fc.shard_seed(9, rank))
        got_rows, got_rewards = r["rollout"]
        assert got_rewards.shape == (T, P // 2)
        assert torch.equal(got_rewards, rewards)
        for x, y in zip(got_rows.fields(), rows.fields()):
            assert torch.equal(x, y)
        assert r["raised"] == ["num_envs 15 does not split over 2 ranks"] * 2


def test_shard_seed_int32():
    """Seeds follow the JAX package's int32 arithmetic: the offset wraps,
    on an int and on a device seed alike."""
    big = (1 << 31) - 5
    assert fc.shard_seed(big, 1) == big + (1 << 20) - (1 << 32)
    t = fc.seed_tensor(big, torch.device("cpu"))
    assert int(fc.shard_seed(t, 1)) == big + (1 << 20) - (1 << 32)
    assert fc.shard_seed(t, 0) is t


# ----------------------------------------------------------------------
# (e) the CLI
# ----------------------------------------------------------------------

TINY = ["--device", "cpu", "-np", "8", "-bl", "20", "-bs", "20", "-ne", "2",
        "-se", "3"]
REPEAT = 8 * 20


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(argv, cwd):
    os.makedirs(cwd, exist_ok=True)
    tmp = os.path.join(os.path.dirname(cwd), f"{os.path.basename(cwd)}.tmp")
    os.makedirs(tmp, exist_ok=True)  # the file:// rendezvous of --num-data
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=tmp,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.Popen([sys.executable, "-m", "marlnav_tpu_torch",
                             *argv], cwd=str(cwd), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def finish(procs, timeout=180.0):
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                os.killpg(p.pid, 9)
            pytest.fail(f"{proc.args} did not finish in {timeout} s")
        assert proc.returncode == 0, (proc.args, err[-3000:])


def artifacts(root):
    """{name: array} of the run's weights, {name: text} of its logs."""
    (actor,) = glob.glob(os.path.join(root, "weights", "*_actor.npz"))
    stem = actor[:-len("_actor.npz")]
    w = {}
    for net in ("actor", "critic"):
        with np.load(f"{stem}_{net}.npz") as data:
            w.update({f"{net}.{k}": data[k] for k in data})
    logs = {os.path.basename(p).split("_", 1)[1]: open(p).read()
            for p in glob.glob(os.path.join(root, "logs", "*"))}
    return w, logs


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    three = TINY + ["-nt", str(3 * REPEAT)]
    port, port1 = free_port(), free_port()
    multi = ["--multihost", "--coordinator-address", f"localhost:{port}",
             "--num-processes", "2", "--num-data", "2"]
    finish([
        start(three + ["--num-data", "2"], root / "straight"),
        start(TINY + ["-nt", str(2 * REPEAT), "--num-data", "2",
                      "--checkpoint-dir", str(root / "ck")], root / "part"),
        start(three + multi + ["--process-id", "0"], root / "multi0"),
        start(three + multi + ["--process-id", "1"], root / "multi1"),
        start(three + ["--multihost", "--coordinator-address",
                       f"localhost:{port1}", "--num-processes", "1",
                       "--process-id", "0", "--num-data", "1"],
              root / "single")])
    shutil.copytree(root / "ck", root / "ck1")
    finish([start(three + ["--num-data", "2", "--checkpoint-dir",
                           str(root / "ck"), "--resume"], root / "resume2"),
            start(three + ["--checkpoint-dir", str(root / "ck1"),
                           "--resume"], root / "resume1")])
    return root


def test_cli_num_data_2_trains_rank0_writes(cli_runs):
    """--num-data 2 --device cpu trains at 2 ranks; only rank 0 writes
    (one weights pair, finite logs of 3 repeats); the spawned rank and the
    second --multihost process (its own --output-root) write nothing."""
    for run in ("straight", "multi0"):
        w, logs = artifacts(cli_runs / run)
        assert len(os.listdir(cli_runs / run / "weights")) == 2
        rews = [float(v) for v in logs["mean_rews.csv"].split()[1:]]
        assert len(rews) == 3 and np.isfinite(rews).all()
        assert all(np.isfinite(x).all() for x in w.values())
    assert os.listdir(cli_runs / "multi1") == []


def test_cli_two_multihost_processes_equal_num_data_2(cli_runs):
    w, logs = artifacts(cli_runs / "straight")
    w_m, logs_m = artifacts(cli_runs / "multi0")
    assert logs_m == logs
    for k, v in w.items():
        np.testing.assert_array_equal(w_m[k], v, err_msg=k)


def test_cli_multihost_one_process(cli_runs):
    """--multihost with the three coordination flags initializes
    torch.distributed for real (one process, tcp://) and trains as the
    run without a mesh does, within (a)'s tolerances."""
    w, logs = artifacts(cli_runs / "single")
    w_2, logs_2 = artifacts(cli_runs / "straight")
    for k, v in w_2.items():
        np.testing.assert_allclose(w[k], v, rtol=2e-4, atol=1e-5, err_msg=k)
    assert len(logs["act_loss.csv"].split()) == 1 + 3 * 2


def test_cli_checkpoint_resumes_across_world_sizes(cli_runs):
    """A checkpoint written at 2 ranks (2 repeats) resumes at 2 ranks bit
    for bit against 3 straight repeats at 2 ranks, and without a mesh
    within (a)'s tolerances; it holds the global env state."""
    from marlnav_tpu_torch.utils.checkpoint import Checkpointer

    step, tree, _ = Checkpointer(str(cli_runs / "ck")).restore(1)
    assert step == 1 and tree["env"]["states"].shape[0] == 8
    w, logs = artifacts(cli_runs / "straight")
    w_2, logs_2 = artifacts(cli_runs / "resume2")
    assert logs_2["mean_rews.csv"] == logs["mean_rews.csv"]
    assert logs_2["act_loss.csv"] == logs["act_loss.csv"]
    for k, v in w.items():
        np.testing.assert_array_equal(w_2[k], v, err_msg=k)
    w_1, logs_1 = artifacts(cli_runs / "resume1")
    for k, v in w.items():
        np.testing.assert_allclose(w_1[k], v, rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        [float(v) for v in logs_1["mean_rews.csv"].split()[1:]],
        [float(v) for v in logs["mean_rews.csv"].split()[1:]], rtol=1e-5)
