"""Tensor parallelism of the port (``--num-model``) on the CPU, over gloo
ranks, against the JAX package's 4 x 2 ('data', 'model') mesh on its 8
CPU devices (tests/conftest.py) and against the port without a mesh.

(a) the split ``Actor`` / ``Critic`` forward at ``num_model`` 2 and 4,
    float32 and bf16, equals ``actor_apply`` / ``critic_apply`` on the
    JAX mesh with ``shard_train_state(..., tensor_parallel=True)``
    (tests/test_sharding.py:94-112's tolerances, rtol 1e-5, atol 1e-6);
(b) the actor and critic phases on the autograd route and the kernels'
    plain route, at 1 x 2 and 2 x 2, equal the JAX package's
    tensor-parallel phases from the same parameters and numpy buffer
    (tests/test_sharding.py:80-92's, rtol 2e-4, atol 1e-5), faithful and
    GAE;
(c) collect -> actor -> critic at 1 x 2 equals the run without a mesh:
    the fused route on injected uniforms, the plain route with a tamed
    policy (``tame``), at tests/test_torch_data_parallel.py's tolerances;
(d) the grid: rank d M + m and both groups' members; ``-hs 50`` at
    ``num_model`` 4 raises ``ValueError`` in both packages;
(e) the CLI: ``--num-model 2 --device cpu`` trains (spawned, and as two
    ``--multihost`` processes of which only process 0 writes), its weight
    file loads into an unsharded ``Actor``, and a 1 x 2 checkpoint
    resumes at 1 x 2 bit for bit and without a mesh.

The ranks of (a)-(d) run as two groups at once, 2 ranks (a 1 x 2 grid)
and 4 (a 2 x 2 and a 1 x 4 grid), each in a subprocess with its own
timeout (``test_torch_parallel.run_group``); the CLI runs are
subprocesses with timeouts.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.algo.mappo import Buffer, TrainState, make_adam
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor, Critic
from marlnav_tpu_torch.models.networks import flat_params, load_flat_params
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.utils.seeding import make_generator
from test_torch_data_parallel import (A, EP, H, ICFG, NORM, OBS, REPEAT,
                                      SCAL, TINY, artifacts, close,
                                      close_weights, config, finish,
                                      free_port, rand_buffer, start,
                                      uniforms)
from test_torch_parallel import run_group

MODES = ("faithful", "gae")
N_FWD = 16  # envs of the forward's observations


def whole_weights(ts):
    from marlnav_tpu_torch.parallel.tensor import gather_networks

    actor, critic = gather_networks([ts.actor, ts.critic])
    return {"actor": flat_params(actor), "critic": flat_params(critic)}


def grid(num_model, num_data=None):
    from marlnav_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(num_data, num_model, device="cpu")


def layout(mesh):
    import torch.distributed as dist

    return dict(rank=mesh.rank, data=mesh.data_index, model=mesh.model_index,
                data_group=dist.get_process_group_ranks(mesh.data_group),
                model_group=dist.get_process_group_ranks(mesh.model_group))


def split_networks(inputs, mesh):
    from marlnav_tpu_torch.parallel.tensor import shard_network

    actor = load_flat_params(Actor(OBS, H, 2), inputs["actor"])
    critic = load_flat_params(Critic(OBS, A, H), inputs["critic"])
    return shard_network(actor, mesh), shard_network(critic, mesh)


@torch.no_grad()
def forward(mesh, inputs):
    """(a): the split networks on the numpy observations."""
    actor, critic = split_networks(inputs["forward"], mesh)
    obs = torch.from_numpy(inputs["obs"])
    return {name: (*actor(obs, dtype), critic(obs, dtype))
            for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}


def phases(mesh, inputs, mode, route):
    """(b): the update phases from the JAX package's parameters and a
    numpy buffer; the whole networks after them."""
    from marlnav_tpu_torch.parallel import shard_buffer

    cfg = config(mode, fused_updates=route == "fused")
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    mappo = make_mappo(cfg, env, NORM, SCAL, mesh=mesh)
    actor, critic = split_networks(inputs[mode], mesh)
    ts = TrainState(actor, critic, make_adam(actor, cfg.lr),
                    make_adam(critic, cfg.lr))
    buf = Buffer(**{k: torch.from_numpy(v) for k, v in
                    inputs[mode]["buffer"].items()})
    if mesh is not None:
        buf = shard_buffer(buf, mesh, A)
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    return dict(al=al, cl=cl, weights=whole_weights(ts))


@torch.no_grad()
def tame(actor):
    """tests/test_fused_collect.py tame_policy on a port actor (split or
    whole, in place): mean head x1e-3, variance bias -20."""
    actor.fc_mu.weight.mul_(1e-3)
    actor.fc_mu.bias.mul_(1e-3)
    actor.fc_var.bias.sub_(20.0)


def run(route, mesh):
    """(c): one collect, then both phases, from the run seed."""
    cfg = config("faithful", fused_updates=route == "fused")
    env = make_env(EP, ICFG, "cpu", mesh=mesh)
    mappo = make_mappo(cfg, env, NORM, SCAL, mesh=mesh)
    g = make_generator(0)
    ts, es = mappo.init(g)
    if route == "fused":
        collect = fc.make_fused_collect(cfg, EP, ICFG, NORM, SCAL, mesh)
        es, buf, met = collect(ts, fc.env_state_to_rows(es), 7, uniforms())
        state = es.fields()
    else:
        tame(ts.actor)
        es, buf, met = mappo.collect(ts, es, g)
        state = [es.states]
    ts, al = mappo.train_actor(ts, buf)
    ts, cl = mappo.train_critic(ts, buf)
    return dict(state=state, returns=buf.returns, mean_rew=met.mean_rew,
                stats=[int(x) for x in (met.stats.num_trunc,
                                        met.stats.num_col,
                                        met.stats.num_tar)],
                al=al, cl=cl, weights=whole_weights(ts))


def _inputs(out_dir):
    return torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)


def _ranks_1x2(rank, world, out_dir):
    inputs = _inputs(out_dir)
    mesh = grid(2)
    out = {"layout": layout(mesh), "forward": forward(mesh, inputs),
           "runs": {route: run(route, mesh) for route in ("plain", "fused")}}
    out.update({(mode, route): phases(mesh, inputs, mode, route)
                for mode in MODES for route in ("autograd", "fused")})
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _ranks_4(rank, world, out_dir):
    from marlnav_tpu_torch.parallel.tensor import shard_network

    inputs = _inputs(out_dir)
    mesh, mesh4 = grid(2, 2), grid(4)
    out = {"layout": layout(mesh), "layout4": layout(mesh4),
           "forward": forward(mesh4, inputs)}
    out.update({(mode, route): phases(mesh, inputs, mode, route)
                for mode in MODES for route in ("autograd", "fused")})
    try:
        shard_network(Actor(OBS, 50, 2), mesh4)
    except ValueError as err:
        out["raised"] = str(err)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def jax_tree_flat(ts):
    return {name: {f"{k}.{leaf}": np.asarray(getattr(d, leaf))
                   for k, d in getattr(ts, name)._asdict().items()
                   for leaf in ("w", "b")}
            for name in ("actor", "critic")}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The JAX package's initial parameters, a numpy buffer a mode and
    numpy observations, then both groups of ranks at once; returns their
    ranks' results and the inputs."""
    import dataclasses

    import jax

    from marlnav_tpu.algo import make_mappo as j_make_mappo
    from marlnav_tpu.config import EnvParams as JEnvParams
    from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
    from marlnav_tpu.config import NormalizerConfig as JNorm
    from marlnav_tpu.config import ScalerConfig as JScal
    from marlnav_tpu.config import TriangleInitConfig as JTri
    from marlnav_tpu.env import make_env as j_make_env

    inputs = {}
    for i, mode in enumerate(MODES):
        jcfg = JMAPPOConfig(**dataclasses.asdict(config(mode)))
        jenv = j_make_env(JEnvParams(**dataclasses.asdict(EP)),
                          JTri(**dataclasses.asdict(ICFG)), None)
        jm = j_make_mappo(jcfg, jenv, JNorm(), JScal())
        ts, _ = jm.init(jax.random.PRNGKey(i))
        inputs[mode] = dict(jax_tree_flat(ts), buffer=rand_buffer(i),
                            jax=(jm, ts))
    ts, _ = jm.init(jax.random.PRNGKey(5))
    inputs["forward"] = dict(jax_tree_flat(ts), jax=ts)
    inputs["obs"] = np.random.default_rng(3).normal(
        size=(N_FWD, A, OBS)).astype(np.float32)
    kept = {k: ({kk: vv for kk, vv in v.items() if kk != "jax"}
                if isinstance(v, dict) else v) for k, v in inputs.items()}
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    for d in dirs.values():
        torch.save(kept, os.path.join(d, "inputs.pt"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run_group, "test_torch_tensor_parallel",
                                  "_ranks_1x2" if w == 2 else "_ranks_4",
                                  w, dirs[w], 240.0)
                   for w in (2, 4)}
        ranks = {w: f.result() for w, f in futures.items()}
    return ranks, inputs


def jax_mesh(num_model=2):
    from marlnav_tpu.parallel import make_mesh

    return make_mesh(num_data=8 // num_model, num_model=num_model)


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_forward_matches_jax_mesh(groups, num_model, dtype):
    """(a) Every rank's split forward equals the JAX package's on its 4 x 2
    mesh with the tensor-parallel sharding."""
    import jax
    import jax.numpy as jnp

    from marlnav_tpu.models import actor_apply, critic_apply
    from marlnav_tpu.parallel import shard_train_state

    ranks, inputs = groups
    ts = inputs["forward"]["jax"]
    s_ts = shard_train_state(ts, jax_mesh(), tensor_parallel=True)
    cd = jnp.bfloat16 if dtype == "bf16" else None
    mean, var = jax.jit(actor_apply, static_argnums=2)(
        s_ts.actor, inputs["obs"], cd)
    value = jax.jit(critic_apply, static_argnums=2)(
        s_ts.critic, inputs["obs"], cd)
    for r in ranks[num_model]:
        for got, want in zip(r["forward"][dtype], (mean, var, value)):
            close(got, want, 1e-5, 1e-6, f"{dtype} at num_model {num_model}")


@pytest.mark.parametrize("grid_shape", ["1x2", "2x2"])
@pytest.mark.parametrize("route", ["autograd", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_phases_match_jax_tensor_parallel(groups, grid_shape, route, mode):
    """(b) The JAX package's update phases on its 4 x 2 mesh, the train
    state tensor-parallel and the buffer over 'data', against the port's
    at 1 x 2 and 2 x 2 from the same parameters and buffer."""
    import jax

    from marlnav_tpu.algo import Buffer as JBuffer
    from marlnav_tpu.parallel import buffer_shardings, shard_train_state

    ranks, inputs = groups
    jm, ts = inputs[mode]["jax"]
    mesh = jax_mesh()
    jbuf = jax.device_put(
        JBuffer(**{k: np.asarray(v) for k, v in
                   inputs[mode]["buffer"].items()}), buffer_shardings(mesh))
    ts = shard_train_state(ts, mesh, tensor_parallel=True)
    ts, al = jax.jit(jm.train_actor)(ts, jbuf)
    ts, cl = jax.jit(jm.train_critic)(ts, jbuf)
    got = [r[(mode, route)] for r in ranks[2 if grid_shape == "1x2" else 4]]
    for r in got:
        close(r["al"], al, 2e-4, 1e-5, "actor losses")
        close(r["cl"], cl, 2e-4, 1e-5, "critic losses")
    close_weights([r["weights"] for r in got], jax_tree_flat(ts), 2e-4,
                  1e-5)


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_one_by_two_equals_no_mesh(groups, route):
    """(c) collect -> actor -> critic at 1 x 2 against the run without a
    mesh from the same seed: both ranks hold the same envs, the same
    buffer and, gathered, the same networks."""
    want = run(route, None)
    rtol, atol = (1e-4, 1e-5) if route == "fused" else (2e-4, 1e-5)
    for r in (x["runs"][route] for x in groups[0][2]):
        assert r["stats"] == want["stats"]
        close(r["mean_rew"], want["mean_rew"], 1e-5, 0, "mean_rew")
        close(r["returns"], want["returns"], 1e-4, 1e-5, "returns")
        for got, x in zip(r["state"], want["state"]):
            close(got, x, 1e-5, 1e-3, "env state")
        close(r["al"], want["al"], rtol, atol, "actor losses")
        close(r["cl"], want["cl"], rtol, atol, "critic losses")
        close_weights([r["weights"]], want["weights"], rtol, atol)


def test_grid_layout_and_uneven_hidden(groups):
    """(d) Rank r sits at data index r // M and model index r % M; the
    data group is its column, the model group its row; a hidden size that
    does not split over the model axis raises ValueError here as the JAX
    package's device_put does."""
    from marlnav_tpu.parallel import shard_train_state

    ranks, inputs = groups
    want = {2: [(r, 0, r, [r], [0, 1]) for r in range(2)],
            4: [(r, r // 2, r % 2, [r % 2, r % 2 + 2],
                 [r // 2 * 2, r // 2 * 2 + 1]) for r in range(4)]}
    for world in (2, 4):
        got = [tuple(x["layout"].values()) for x in ranks[world]]
        assert got == want[world]
    assert [tuple(x["layout4"].values()) for x in ranks[4]] == [
        (r, 0, r, [r], [0, 1, 2, 3]) for r in range(4)]
    for r in ranks[4]:
        assert r["raised"].startswith("hidden size 50 does not split over "
                                      "--num-model 4")
    import jax

    from marlnav_tpu.models import actor_init

    jts = inputs["faithful"]["jax"][1]
    wide = jts._replace(actor=actor_init(jax.random.PRNGKey(0), OBS, 50))
    with pytest.raises(ValueError):
        shard_train_state(wide, jax_mesh(4), tensor_parallel=True)


# ----------------------------------------------------------------------
# (e) the CLI
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    three = TINY + ["-nt", str(3 * REPEAT), "--num-model", "2",
                    "--num-data", "1"]
    multi = three + ["--multihost", "--coordinator-address",
                     f"localhost:{free_port()}", "--num-processes", "2"]
    finish([
        start(three, root / "straight"),
        start(TINY + ["-nt", str(2 * REPEAT), "--num-model", "2",
                      "--num-data", "1", "--checkpoint-dir",
                      str(root / "ck")], root / "part"),
        start(multi + ["--process-id", "0"], root / "multi0"),
        start(multi + ["--process-id", "1"], root / "multi1")])
    import shutil

    shutil.copytree(root / "ck", root / "ck1")
    finish([start(three + ["--checkpoint-dir", str(root / "ck"),
                           "--resume"], root / "resume2"),
            start(TINY + ["-nt", str(3 * REPEAT), "--checkpoint-dir",
                          str(root / "ck1"), "--resume"], root / "resume1")])
    return root


def test_cli_num_model_2_trains_rank0_writes(cli_runs):
    """--num-model 2 --device cpu spawns its second rank and trains; one
    weights pair, whole (12, 50) tensors that load into an unsharded
    Actor and Critic; finite logs of 3 repeats."""
    w, logs = artifacts(cli_runs / "straight")
    assert len(os.listdir(cli_runs / "straight" / "weights")) == 2
    rews = [float(v) for v in logs["mean_rews.csv"].split()[1:]]
    assert len(rews) == 3 and np.isfinite(rews).all()
    assert w["actor.fc1.w"].shape == (12, 50)
    actor = load_flat_params(Actor(12, 50, 2), {
        k.split(".", 1)[1]: v for k, v in w.items() if k.startswith("actor")})
    critic = load_flat_params(Critic(12, 3, 50), {
        k.split(".", 1)[1]: v for k, v in w.items()
        if k.startswith("critic")})
    mean, var = actor(torch.zeros(4, 3, 12))
    assert mean.shape == (12, 2) and torch.isfinite(var).all()
    assert critic(torch.zeros(4, 3, 12)).shape == (4, 1)


def test_cli_multihost_1x2_rank0_writes(cli_runs):
    """--num-model 2 over two --multihost processes, each in its own
    directory: process 0 writes what the spawned 1 x 2 run writes, bit for
    bit; process 1 writes nothing."""
    w, logs = artifacts(cli_runs / "straight")
    w_m, logs_m = artifacts(cli_runs / "multi0")
    assert logs_m == logs
    for k, v in w.items():
        np.testing.assert_array_equal(w_m[k], v, err_msg=k)
    assert os.listdir(cli_runs / "multi1") == []


def test_cli_checkpoint_resumes_at_1x2_and_without(cli_runs):
    """A checkpoint written at 1 x 2 (2 repeats) holds whole networks and
    Adam moments; it resumes at 1 x 2 bit for bit against 3 straight
    repeats, and without a mesh within (b)'s tolerances."""
    from marlnav_tpu_torch.utils.checkpoint import Checkpointer

    _, tree, _ = Checkpointer(str(cli_runs / "ck")).restore(1)
    assert tree["actor"]["fc1.weight"].shape == (50, 12)
    assert tree["critic_opt"]["state"][2]["exp_avg"].shape == (1, 50)
    w, logs = artifacts(cli_runs / "straight")
    w_2, logs_2 = artifacts(cli_runs / "resume2")
    assert logs_2["mean_rews.csv"] == logs["mean_rews.csv"]
    assert logs_2["act_loss.csv"] == logs["act_loss.csv"]
    for k, v in w.items():
        np.testing.assert_array_equal(w_2[k], v, err_msg=k)
    w_1, _ = artifacts(cli_runs / "resume1")
    for k, v in w.items():
        np.testing.assert_allclose(w_1[k], v, rtol=2e-4, atol=1e-5,
                                   err_msg=k)
