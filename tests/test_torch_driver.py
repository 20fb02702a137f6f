"""The port's training loop on the CPU: blocks of repeats
(``--jit-repeats``, ``--pipeline-repeats``), checkpoints and exact resume,
and the five flags that drive them through the CLI.

On the CPU a block runs without capture, in the block structure the card
runs as CUDA graphs (``tests_cuda/test_cuda_graph.py`` and
``chip_smoke.py`` hold the graphs against the eager loop there).  Every
comparison here is bitwise: weights, Adam states, the final env state and
the logs.
"""

import glob
import os

import numpy as np
import pytest
import torch

from marlnav_tpu_torch.__main__ import build_parser, cli
from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.train import fold_seed, train
from marlnav_tpu_torch.utils.checkpoint import Checkpointer
from marlnav_tpu_torch.utils.seeding import make_generator
from marlnav_tpu_torch.utils.stats import StatsLogger

TINY = ["--device", "cpu", "-np", "8", "-bl", "20", "-bs", "20", "-ne", "2",
        "-se", "3"]
ROUTES = {"plain": False, "fused": True}


def _cfg(repeats, *extra):
    return resolve_run_config(build_parser().parse_args(
        TINY + ["-nt", str(repeats * 8 * 20), *extra]))


def _run(tmp_path, repeats, fused, name, **kw):
    return train(_cfg(repeats, "--fused-updates" if fused else
                      "--use-gae"), device="cpu", fused_collect=fused,
                 verbose=False, output_root=str(tmp_path / name), **kw)


def _state_tensors(state):
    if isinstance(state, fc.RowState):
        return state.fields()
    return [state.states, state.obstacles, state.target, state.step_num,
            state.terminates]


def _assert_same_run(a, b):
    """Two train() results equal bit for bit."""
    (ts_a, st_a, log_a), (ts_b, st_b, log_b) = a, b
    for m_a, m_b in ((ts_a.actor, ts_b.actor), (ts_a.critic, ts_b.critic)):
        for (name, x), y in zip(m_a.state_dict().items(),
                                m_b.state_dict().values()):
            assert torch.equal(x, y), name
    for o_a, o_b in ((ts_a.actor_opt, ts_b.actor_opt),
                     (ts_a.critic_opt, ts_b.critic_opt)):
        for s_a, s_b in zip(o_a.state_dict()["state"].values(),
                            o_b.state_dict()["state"].values()):
            for key in s_a:
                assert torch.equal(s_a[key], s_b[key]), key
    for x, y in zip(_state_tensors(st_a), _state_tensors(st_b), strict=True):
        assert torch.equal(x, y)
    assert log_a.logs == log_b.logs


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Per route, runs of 3 and 4 repeats one repeat at a time."""
    tmp = tmp_path_factory.mktemp("straight")
    return {(route, n): _run(tmp, n, fused, f"{route}{n}")
            for route, fused in ROUTES.items() for n in (3, 4)}


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["jit-repeats", "pipeline-repeats"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_blocks_equal_the_per_repeat_loop(tmp_path, straight, route,
                                          pipeline):
    """jit_repeats 3 over 4 repeats (a block of 3, then a tail of 1), in
    both block modes, equals the loop of single repeats."""
    got = _run(tmp_path, 4, ROUTES[route], "blocks", jit_repeats=3,
               pipeline=pipeline)
    _assert_same_run(got, straight[(route, 4)])
    assert len(got[2].logs["mean_rews"]) == 4
    assert len(got[2].logs["actor"]) == 4 * 2


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_resume_equals_a_straight_run(tmp_path, straight, route):
    """2 repeats with checkpoints, then a resume for the third, equal 3
    repeats in one run."""
    ck = str(tmp_path / "ck")
    _run(tmp_path, 2, ROUTES[route], "first", checkpoint_dir=ck)
    # The first block holds repeat 0, a multiple of the interval (10); the
    # final save is forced.
    assert Checkpointer(ck).all_steps() == [0, 1]
    resumed = _run(tmp_path, 3, ROUTES[route], "resumed", checkpoint_dir=ck,
                   resume=True)
    _assert_same_run(resumed, straight[(route, 3)])
    assert Checkpointer(ck).all_steps() == [0, 1, 2]


@pytest.mark.parametrize("first", sorted(ROUTES),
                         ids=lambda r: f"{r}-then-other")
def test_resume_across_a_fused_collect_flip(tmp_path, first):
    """A checkpoint holds the canonical EnvState on both routes, so the
    other route resumes from it.  The fused route threads no generator: its
    checkpoint at step s holds a generator seeded from (seed, s)."""
    ck = str(tmp_path / "ck")
    fused = ROUTES[first]
    ts, state, log = train(_cfg(2), device="cpu", fused_collect=fused,
                           verbose=False, output_root=str(tmp_path / "a"),
                           checkpoint_dir=ck)
    step, tree, host = Checkpointer(ck).restore()
    assert step == 1 and host["logs"] == log.logs
    canon = (fc.rows_to_env_state(state, make_generator(0)) if fused
             else state)
    for name in ("states", "obstacles", "target", "step_num", "terminates"):
        assert torch.equal(tree["env"][name], getattr(canon, name)), name
    if fused:
        assert torch.equal(tree["generator"], make_generator(
            fold_seed(3, 1)).get_state())
        assert not torch.equal(tree["generator"], make_generator(
            fold_seed(3, 0)).get_state())
    _, state_b, log_b = train(_cfg(3), device="cpu", fused_collect=not fused,
                              verbose=False, output_root=str(tmp_path / "b"),
                              checkpoint_dir=ck, resume=True)
    assert log_b.logs["mean_rews"][:2] == log.logs["mean_rews"]
    assert len(log_b.logs["mean_rews"]) == 3
    assert np.isfinite(log_b.logs["mean_rews"]).all()
    assert isinstance(state_b, fc.RowState) == (not fused)


def test_checkpointer_interval_duplicates_and_keep_three(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), save_interval=3)
    tree = {"w": torch.arange(4.0), "g": make_generator(5).get_state()}
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    assert not ck.save(1, tree)  # off the interval
    assert ck.save(1, tree, {"a": [1]}, force=True)
    assert not ck.save(1, tree, force=True)  # already saved
    for step in (3, 6, 9):
        assert ck.save(step, {"w": torch.full((2,), float(step))})
    assert ck.all_steps() == [3, 6, 9]  # keeps the 3 latest
    assert sorted(os.listdir(ck.directory)) == ["ckpt_3.pt", "ckpt_6.pt",
                                                "ckpt_9.pt"]  # no temp file
    step, got, host = ck.restore()
    assert step == 9 and torch.equal(got["w"], torch.full((2,), 9.0))
    assert host is None and ck.restore(6)[1]["w"][0] == 6.0
    with pytest.raises(ValueError):
        Checkpointer(str(tmp_path / "x"), save_interval=0)


def test_checkpoints_follow_the_block_crossing_rule(tmp_path):
    """jit_repeats 2, interval 3, 7 repeats: blocks end at repeats 1, 3,
    5 and 6; a block saves when it holds a multiple of the interval (1: the
    first block holds 0; 3; 6), and the final forced save finds 6 saved
    (marlnav_tpu/train.py:314-338)."""
    ck = str(tmp_path / "ck")
    train(_cfg(7), device="cpu", verbose=False, jit_repeats=2,
          output_root=str(tmp_path / "o"), checkpoint_dir=ck,
          checkpoint_interval=3)
    assert Checkpointer(ck).all_steps() == [1, 3, 6]


def test_logger_state_dict_round_trip(tmp_path):
    a = StatsLogger(root=str(tmp_path), timestamp="20260101000000")
    a.logs["mean_rews"] += [1.5, -2.0]
    a.logs["actor"] += [0.25]
    a.logs["epi_stats"]["col"] += [3]
    b = StatsLogger(root=str(tmp_path))
    b.load_state_dict(a.state_dict())
    assert b.time == "20260101000000" and b.logs == a.logs
    assert set(a.state_dict()) == {"time", "logs"}


def test_train_many_equals_its_repeats():
    """MAPPO.train_many stacks what the repeats of its loop return."""
    cfg = _cfg(2)
    env = make_env(cfg.env, cfg.init, "cpu")
    runs = []
    for many in (True, False):
        mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler)
        g = make_generator(3)
        ts, es = mappo.init(g)
        if many:
            ts, es, met, al, cl = mappo.train_many(ts, es, g, 2)
        else:
            per = []
            for _ in range(2):
                es, buf, m = mappo.collect(ts, es, g)
                ts, a = mappo.train_actor(ts, buf)
                ts, c = mappo.train_critic(ts, buf)
                per.append((m, a, c))
            met = (torch.stack([m.mean_rew for m, _, _ in per]),
                   torch.stack([m.stats.num_col for m, _, _ in per]))
            al = torch.stack([a for _, a, _ in per])
            cl = torch.stack([c for _, _, c in per])
        if many:
            assert al.shape == cl.shape == (2, 2)
            met = (met.mean_rew, met.stats.num_col)
        runs.append((ts.actor.fc1.weight.detach(), *met, al, cl, es.states))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_jit_repeats_below_one_raises(tmp_path):
    with pytest.raises(ValueError, match="jit_repeats"):
        train(_cfg(2), device="cpu", jit_repeats=0,
              output_root=str(tmp_path))


def test_collect_seed_tensor():
    """The collect kernel reads its seed from device memory: an int goes in
    as its low 32 bits in one int32, a one-element int32 tensor as itself."""
    assert int(fc.seed_tensor(5, torch.device("cpu"))) == 5
    assert int(fc.seed_tensor(0xFFFFFFFF, torch.device("cpu"))) == -1
    assert int(fc.seed_tensor((1 << 32) + 7, torch.device("cpu"))) == 7
    seed = torch.tensor([9], dtype=torch.int32)
    assert fc.seed_tensor(seed, torch.device("cpu")) is seed
    with pytest.raises(ValueError, match="int32"):
        fc.seed_tensor(torch.tensor([9]), torch.device("cpu"))


@pytest.mark.parametrize("flags", [
    ["--jit-repeats", "2"], ["--jit-repeats", "2", "--pipeline-repeats"],
    ["--checkpoint-dir", "ck"], ["--checkpoint-dir", "ck", "--resume"],
    ["--returns-f64"]], ids=lambda f: "+".join(x for x in f if "-" in x))
def test_ported_flags_through_the_cli(tmp_path, monkeypatch, capsys, flags):
    """Each flag reaches train() from the CLI on a tiny config, with
    --fused-collect --fused-updates: 3 repeats, 2 epochs each."""
    monkeypatch.chdir(tmp_path)
    argv = TINY + ["--fused-collect", "--fused-updates"] + flags
    if "--resume" in flags:
        cli(argv + ["-nt", "320"])  # 2 repeats, checkpointed at 1
    capsys.readouterr()
    cli(argv + ["-nt", str(3 * 8 * 20)])
    out = capsys.readouterr().out
    # A resumed run keeps the first run's timestamp: one file either way.
    (log,) = glob.glob(str(tmp_path / "logs" / "*_mean_rews.csv"))
    rews = [float(v) for v in open(log).read().split()[1:]]
    assert len(rews) == 3 and np.isfinite(rews).all()
    if "--jit-repeats" in flags:  # a block of 2, then a tail of 1
        assert "repeat 2/3" in out and "(2 repeat(s)" in out
        assert "repeat 3/3" in out and "repeat 1/3" not in out
    if "--checkpoint-dir" in flags:
        assert Checkpointer(str(tmp_path / "ck")).latest_step() == 2
    if "--resume" in flags:
        assert "resumed from checkpoint at repeat 1" in out
        assert "repeat 3/3" in out and "repeat 2/3" not in out


@pytest.mark.parametrize("written", ["plain", "capturable"])
def test_restore_adam_keeps_the_running_settings(written):
    """An Adam state dict written with other device settings (the CPU's
    plain Adam, or the card's capturable one) loads into the running Adam
    with its own settings kept, its moments and step counts intact, and
    each step count where those settings keep it (on the CPU here)."""
    from marlnav_tpu_torch.models import Actor
    from marlnav_tpu_torch.train import restore_adam

    nets = [Actor(12, 16, generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    settings = {"plain": {}, "capturable": {"capturable": True}}
    writer = torch.optim.Adam(nets[0].parameters(), lr=1e-3,
                              **settings[written])
    for p in nets[0].parameters():
        p.grad = torch.ones_like(p)
    if written == "plain":
        writer.step()
        writer.step()
    other = "capturable" if written == "plain" else "plain"
    runner = torch.optim.Adam(nets[1].parameters(), lr=1e-3,
                              **settings[other])
    state = writer.state_dict()
    if written == "capturable":  # a card's state: steps beside the params
        for p in nets[0].parameters():
            writer.state[p] = {"step": torch.tensor(2.0),
                               "exp_avg": torch.full_like(p, 0.5),
                               "exp_avg_sq": torch.full_like(p, 0.25)}
        state = writer.state_dict()
    restore_adam(runner, state)
    assert runner.param_groups[0]["capturable"] == (other == "capturable")
    assert writer.param_groups[0]["capturable"] == (written == "capturable")
    for p_w, p_r in zip(nets[0].parameters(), nets[1].parameters()):
        st_w, st_r = writer.state[p_w], runner.state[p_r]
        assert float(st_r["step"]) == 2.0
        assert st_r["step"].dtype == torch.float32
        assert st_r["step"].device.type == "cpu"
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st_r[key], st_w[key])


def test_restore_generator_from_the_other_device_kind():
    """A generator state of this kind continues its stream; one of the
    other device's kind (another size, as the card's Philox state is to
    the CPU's) seeds the generator from its bytes: the same state, the
    same draws; another state, other draws."""
    from marlnav_tpu_torch.train import restore_generator

    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    want = torch.rand(4, generator=g)
    restore_generator(g, state)
    assert torch.equal(torch.rand(4, generator=g), want)
    foreign = [torch.tensor([i, 0, 0, 0, 7, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
                            dtype=torch.uint8) for i in (1, 2)]
    draws = []
    for state in (foreign[0], foreign[0], foreign[1]):
        restore_generator(g, state)
        draws.append(torch.rand(4, generator=g))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
