"""The port's data-parallel layer (``marlnav_tpu_torch/parallel/``) on the
CPU: ``make_mesh``'s checks, and the collectives behind the global parts
of MAPPO — the faithful advantage pairing and the returns normalization —
over gloo ranks, against the JAX package on its 8-device CPU mesh
(tests/conftest.py).

Each group of ranks runs in a subprocess of its own session with a
timeout (``run_group``), its ranks spawned by ``parallel.launch``, and
meets at a ``file://`` rendezvous under the test's temporary directory;
no port is shared between test workers.  The rank functions are this module's
``_ranks_*``, which import nothing of JAX.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlnav_tpu_torch.config import MAPPOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
SIZE, P, A = 3, 16, 3  # pairing: (size, P) returns - values, 3 agents
T = 8  # returns: (T, P) rewards
SIZES = dict(num_parallel=P, buffer_len=T, batch_size=T, num_total=T * P)


def run_group(module: str, target: str, world: int, out_dir,
              timeout: float = 120.0, fails: bool = False):
    """Run ``module.target(rank, world, out_dir)`` on ``world`` gloo ranks
    (``parallel.launch.run_local_ranks``) in a subprocess with one thread a
    rank; fail after ``timeout`` seconds (the whole session killed).
    Returns each rank's ``out_dir/rank<r>.pt``, or, where the group
    ``fails``, asserts that it did and returns its standard error."""
    os.makedirs(out_dir, exist_ok=True)
    script = (
        f"import sys; sys.path[:0] = {[ROOT, TESTS]!r}\n"
        "import torch; torch.set_num_threads(1)\n"
        "from marlnav_tpu_torch.parallel.launch import run_local_ranks\n"
        f"import {module} as m\n"
        f"run_local_ranks({world}, 'gloo', m.{target}, {str(out_dir)!r})\n")
    # TMPDIR: the ranks' file:// rendezvous lies under ``out_dir``.
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(out_dir))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            cwd=str(out_dir), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{world} ranks of {target} did not finish in "
                    f"{timeout} s")
    if fails:
        assert proc.returncode != 0, out[-2000:]
        return err
    assert proc.returncode == 0, (out[-2000:], err[-4000:])
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False)
            for r in range(world)]


def cpu_mesh(rank: int, world: int):
    from marlnav_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world) == (rank, world)
    return mesh


def pairing_inputs():
    return np.random.default_rng(11).normal(size=(SIZE, P)).astype(
        np.float32)


def returns_inputs():
    rng = np.random.default_rng(12)
    rewards = (rng.normal(size=(T, P)) * 100.0).astype(np.float32)
    done = rng.random((T, P)) < 0.2
    values = rng.normal(size=(T, P)).astype(np.float32)
    last = rng.normal(size=(P,)).astype(np.float32)
    return rewards, done, values, last


def _ranks_pairing(rank, world, out_dir):
    """This rank's pairing of its columns, both modes; at world 2 also
    the returns, normalized over the ranks, and the GAE mean_rew."""
    from marlnav_tpu_torch.algo.mappo import (discounted_returns,
                                              gae_advantages, global_mean,
                                              pair_rows_sharded,
                                              reference_returns)
    from marlnav_tpu_torch.parallel import shard

    mesh = cpu_mesh(rank, world)
    d = shard(torch.from_numpy(pairing_inputs()), mesh, 1)
    out = {mode: pair_rows_sharded(d, A, mode == "faithful", mesh)
           for mode in ("faithful", "fixed")}
    if world == 2:
        rewards, done, values, last = (
            shard(torch.from_numpy(x), mesh, x.ndim - 1)
            for x in returns_inputs())
        for f64 in (False, True):
            cfg = MAPPOConfig(returns_f64=f64, **SIZES)
            out[f"returns_f64={f64}"] = reference_returns(rewards, done, cfg,
                                                          mesh)
        cfg = MAPPOConfig(**SIZES)
        out["gae"] = (gae_advantages(rewards, done, values, last, cfg.gamma,
                                     cfg.gae_lambda),
                      global_mean(discounted_returns(rewards, done,
                                                     cfg.gamma), mesh))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {world: run_group("test_torch_parallel", "_ranks_pairing", world,
                             tmp_path_factory.mktemp(f"world{world}"))
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["faithful", "fixed"])
def test_pair_rows_sharded_matches_jax(groups, world, mode):
    """The port of _pair_rows_sharded over gloo ranks equals the JAX
    package's under jax.shard_map on the first ``world`` CPU devices,
    exactly (marlnav_tpu/ops/fused_update.py:200-222)."""
    import jax
    from jax.sharding import PartitionSpec as PS

    from marlnav_tpu.ops.fused_update import _pair_rows_sharded
    from marlnav_tpu.parallel import make_mesh as j_make_mesh

    mesh = j_make_mesh(num_data=world, devices=jax.devices()[:world])
    faithful = mode == "faithful"
    want = jax.shard_map(
        lambda d: _pair_rows_sharded(d, A, faithful, "data"), mesh=mesh,
        in_specs=PS(None, "data"), out_specs=PS("data"))(pairing_inputs())
    got = torch.cat([r[mode] for r in groups[world]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if faithful:  # the global tile crosses the shards
        assert not np.array_equal(
            got.numpy(), np.repeat(pairing_inputs().reshape(-1), A))


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_global_returns_match_jax(groups, f64):
    """Returns normalized over 2 ranks equal the JAX package's
    reference_returns over the whole (T, P) buffer."""
    import jax

    from marlnav_tpu.algo.mappo import reference_returns as j_returns
    from marlnav_tpu.config import MAPPOConfig as JCfg

    rewards, done, _, _ = returns_inputs()
    ranks = [r[f"returns_f64={f64}"] for r in groups[2]]
    got = torch.cat([normed for normed, _ in ranks], 1).numpy()
    if f64:
        jax.config.update("jax_enable_x64", True)
    try:
        want, want_mean = j_returns(rewards, done, JCfg(returns_f64=f64,
                                                        **SIZES))
        want, want_mean = np.asarray(want), float(want_mean)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for _, mean_rew in ranks:
        assert mean_rew.dtype == (torch.float64 if f64 else torch.float32)
        np.testing.assert_allclose(float(mean_rew), want_mean, rtol=1e-5)


def test_global_gae_matches_jax(groups):
    """GAE advantages per rank, its mean_rew over 2 ranks, equal the JAX
    package's over the whole buffer."""
    from marlnav_tpu.algo.mappo import discounted_returns, gae_advantages

    rewards, done, values, last = returns_inputs()
    cfg = MAPPOConfig(**SIZES)
    got = torch.cat([r["gae"][0] for r in groups[2]], 1).numpy()
    want = gae_advantages(rewards, done, values, last, cfg.gamma,
                          cfg.gae_lambda)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    want_mean = float(np.mean(discounted_returns(rewards, done, cfg.gamma)))
    for r in groups[2]:
        np.testing.assert_allclose(float(r["gae"][1]), want_mean, rtol=1e-5)


def _ranks_one_fails(rank, world, out_dir):
    """Rank 1 dies before the first collective; the others wait in it."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 stops here")
    dist.all_reduce(torch.ones(4))


def test_a_failing_rank_fails_the_group(tmp_path):
    """A rank that dies makes the whole run fail, within the timeout: no
    rank goes on alone and exits 0."""
    err = run_group("test_torch_parallel", "_ranks_one_fails", 2, tmp_path,
                    timeout=90.0, fails=True)
    assert "rank 1 stops here" in err


@pytest.fixture
def fake_world():
    """An initialized process group of 8 ranks that runs no collective
    (torch's fake backend), to hold make_mesh's checks at the JAX
    package's 8-device counts."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", [
    ({}, None, None),
    ({"num_data": 8, "num_model": 1}, None, None),
    ({"num_data": 4, "num_model": 2}, None, None),
    ({"num_data": 16, "num_model": 2}, ValueError,
     "mesh 16x2 needs 32 devices, have 8"),
    ({"num_data": 4}, ValueError, "must equal the number of ranks, 8"),
], ids=["default", "8x1", "4x2", "16x2", "4x1"])
def test_make_mesh_checks_as_jax(fake_world, case):
    """tests/test_sharding.py:49-55's cases, counted as ranks: a data
    axis of every rank builds, a 4 x 2 grid builds its data columns and
    model rows (rank 0 at data index 0 and model index 0, the envs split
    over the 4 data indices), and too many devices raise ValueError as
    marlnav_tpu/parallel/mesh.py:35-39 does."""
    import torch.distributed as dist

    from marlnav_tpu_torch.parallel import make_mesh

    kwargs, error, match = case
    if error is None:
        mesh = make_mesh(device="cpu", **kwargs)
        assert (mesh.rank, mesh.world, mesh.device.type) == (0, 8, "cpu")
        d = 8 // mesh.num_model
        assert (mesh.num_data, mesh.data_index, mesh.model_index) == (d, 0, 0)
        if mesh.num_model > 1:
            assert dist.get_process_group_ranks(mesh.data_group) == [
                0, 2, 4, 6]
            assert dist.get_process_group_ranks(mesh.model_group) == [0, 1]
        assert mesh.env_slice(32) == (0, 32 // d)
        with pytest.raises(ValueError, match="num_envs 30 does not split "
                                             f"over {d} ranks"):
            mesh.env_slice(30)
    else:
        with pytest.raises(error, match=match):
            make_mesh(device="cpu", **kwargs)


def test_make_mesh_device_checks(fake_world, monkeypatch):
    """Rank r on the card takes cuda:<local rank>: without CUDA it raises
    naming --device cpu, with fewer cards than local ranks it names the
    count."""
    from marlnav_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 1"):
        make_mesh()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="mesh 8x1 needs 2 devices, have 1"):
        make_mesh()


def test_make_mesh_needs_a_group():
    from marlnav_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(device="cpu")
