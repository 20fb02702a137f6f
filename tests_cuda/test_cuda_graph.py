"""CUDA graphs of the port's kernels and of training blocks, on the card.

One launch of each kernel captured in a tiny graph (``ops.graphs.
CountedGraph``) and replayed equals the same launch run eagerly, bit for
bit; the launch counters count replays and not the capture; the collect
kernel reads its seed from device memory, so a replay after the seed is
rewritten draws the new seed's stream.  Then whole blocks: ``train()``
with ``jit_repeats`` 2 (and ``pipeline``) over 5 repeats, a first eager
block, a graphed block and an eager tail, equals the per-repeat loop bit
for bit on both collect routes, and the counters count what the card ran
(the critic's ``pipelined_launches`` too).
"""

import copy

import pytest
import torch

from marlnav_tpu_torch.__main__ import build_parser
from marlnav_tpu_torch.algo.mappo import make_adam
from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig,
                                      resolve_run_config)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.models import Actor
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_rollout as fr
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import returns as tr
from marlnav_tpu_torch.ops.graphs import CountedGraph, kernel_wrappers
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.train import train
from marlnav_tpu_torch.utils.seeding import make_generator


def _flat(out):
    """The tensors of a kernel wrapper's result, in order."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, fc.RowState):
        return out.fields()
    if isinstance(out, fc.CollectOutput):
        return [*out.rows.fields(), out.obs, out.actions, out.log_probs,
                out.rewards, out.done, out.stats]
    return [x for item in out for x in _flat(item)]


def _kernel_calls(device):
    """name -> a call of each kernel on small inputs."""
    p, t, n, f, h = 300, 16, 1000, 12, 50
    g = torch.Generator(device=device).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    ep = EnvParams(num_parallel=p, episode_len=10)
    ic = TriangleInitConfig(num_parallel=p, noisy_ags=True)
    sm = StepMath(ep, ic, NormalizerConfig(), ScalerConfig())
    rows = fc.env_state_to_rows(make_env(ep, ic, device).init(
        make_generator(1, device)))
    a_comp, c_comp = 0.1 * r(4, f), r(4)
    seed = torch.tensor(7, dtype=torch.int32, device=device)
    rew, done = r(t, p), r(t, p) > 1.0
    x, act, lp, adv = r(n, f), r(n, 2).clamp(-1, 1), r(n) - 2.0, r(n)
    w1, b1, w2, b2 = 0.1 * r(h, 3 * f), r(h), 0.1 * r(1, h), r(1)
    obs3 = r(n, 3 * f)
    uw = (0.1 * r(h, f), r(h), 0.1 * r(2, h), r(2), 0.1 * r(2, h), r(2))
    return {
        "fused_collect": lambda: fc.fused_collect_rows(
            sm, rows, a_comp, c_comp, seed, t),
        "returns": lambda: (tr.returns_scan(rew, done, 0.9),
                            tr.returns_scan(rew, done, 0.9, rew * 0.5, rew[0],
                                            0.95, torch.float64)),
        "fused_actor_grad": lambda: fu.actor_grad_sums(
            a_comp, c_comp, x, act, lp, adv, 0.2, 0.001),
        "fused_critic_grad": lambda: fu.critic_grad_sums(
            w1, b1, w2, b2, obs3, adv, lp, 0.2),
        "fused_actor_grad_uncollapsed": lambda: fu.actor_grad_uncollapsed_sums(
            *uw, x, act, lp, adv, 0.2, 0.001),
        "fused_rollout": lambda: fr.fused_rollout_rows(
            sm, rows, a_comp, c_comp, 9, t, False),
    }, seed


@pytest.mark.cuda
def test_each_kernel_captured_and_replayed_equals_eager(cuda):
    calls, seed = _kernel_calls(cuda)
    assert set(calls) == set(kernel_wrappers())
    wrappers = kernel_wrappers()
    for name, call in calls.items():
        want = [x.clone() for x in _flat(call())]  # eager; loads the kernel
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in wrappers.items()}
        graph = CountedGraph()
        with graph.capture():
            out = call()
        assert {k: fn.launches for k, fn in wrappers.items()} == before, \
            f"{name}: the capture counted launches"
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(_flat(out), want, strict=True):
            assert torch.equal(got, w), name
        per_call = 2 if name == "returns" else 1
        assert graph.launches[name] == per_call
        assert {k: fn.launches - before[k] for k, fn in wrappers.items()} \
            == {k: (2 * per_call if k == name else 0) for k in wrappers}


@pytest.mark.cuda
def test_collect_graph_reads_its_seed_from_device_memory(cuda):
    calls, seed = _kernel_calls(cuda)
    call = calls["fused_collect"]
    call()
    graph = CountedGraph()
    with graph.capture():
        out = call()
    actions = []
    for value in (11, 12):
        seed.fill_(value)
        want = [x.clone() for x in _flat(call())]
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(_flat(out), want, strict=True):
            assert torch.equal(got, w), value
        actions.append(out.actions.clone())
    assert not torch.equal(*actions)


def _tiny(repeats, extra=()):
    return resolve_run_config(build_parser().parse_args(
        ["-np", "64", "-bl", "20", "-bs", "20", "-ne", "2", "-se", "5",
         "-nt", str(repeats * 64 * 20), *extra]))


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["jit-repeats", "pipeline-repeats"])
@pytest.mark.parametrize("route", ["fused", "fused-gae", "fused-f64",
                                   "fused-bf16", "plain", "plain-bf16"])
def test_graphed_blocks_equal_the_eager_loop(cuda, tmp_path, route,
                                             pipeline):
    """The fused route with the fused updates (also with GAE, whose
    bootstrap value reads the final state's observations, with
    --returns-f64 and with --bf16-updates), and the plain route with
    autograd updates (also with --bf16-updates)."""
    fused = route.startswith("fused")
    extra = {"fused": ["--fused-updates"],
             "fused-gae": ["--fused-updates", "--use-gae"],
             "fused-f64": ["--fused-updates", "--returns-f64"],
             "fused-bf16": ["--fused-updates", "--bf16-updates"],
             "plain": [], "plain-bf16": ["--bf16-updates"]}[route]
    wrappers = kernel_wrappers()
    runs = []
    for jit in (1, 2):
        for fn in wrappers.values():
            fn.launches = 0
        fu.critic_grad_sums.pipelined_launches = 0
        ts, state, log = train(_tiny(5, extra), device="cuda",
                               fused_collect=fused, verbose=False,
                               output_root=str(tmp_path / str(jit)),
                               jit_repeats=jit, pipeline=pipeline)
        torch.cuda.synchronize()
        runs.append((ts, state, log,
                     {k: fn.launches for k, fn in wrappers.items()}
                     | {"pipelined": fu.critic_grad_sums.pipelined_launches}))
    (ts_a, st_a, log_a, n_a), (ts_b, st_b, log_b, n_b) = runs
    for x, y in zip([*ts_a.actor.parameters(), *ts_a.critic.parameters()],
                    [*ts_b.actor.parameters(), *ts_b.critic.parameters()]):
        assert torch.equal(x, y)
    for o_a, o_b in ((ts_a.actor_opt, ts_b.actor_opt),
                     (ts_a.critic_opt, ts_b.critic_opt)):
        for s_a, s_b in zip(o_a.state.values(), o_b.state.values()):
            assert all(torch.equal(s_a[k], s_b[k]) for k in s_a)
    fields = (st_a.fields() if fused else
              [st_a.states, st_a.obstacles, st_a.step_num, st_a.terminates])
    other = (st_b.fields() if fused else
             [st_b.states, st_b.obstacles, st_b.step_num, st_b.terminates])
    for x, y in zip(fields, other, strict=True):
        assert torch.equal(x, y)
    assert log_a.logs == log_b.logs and len(log_a.logs["mean_rews"]) == 5
    # Replays count: the graphed block's kernels ran on the card.
    assert n_a == n_b
    # GAE: the mean return's discounted scan, then the advantages'.
    assert n_a["returns"] == (10 if route == "fused-gae" else 5)
    assert n_a["fused_collect"] == (5 if fused else 0)
    assert n_a["fused_actor_grad"] == n_a["fused_critic_grad"] == (
        5 * 2 if fused else 0)
    # The default critic (In 36, H 50) takes the warp-specialised body in
    # float32, on eager repeats and replays alike; its bf16 instance not.
    assert n_a["pipelined"] == (0 if route == "fused-bf16" else
                                n_a["fused_critic_grad"])


@pytest.mark.cuda
def test_card_adam_matches_cpu_adam(cuda):
    """The card's Adam (capturable and fused, ``make_adam``: the settings
    eager and graphed runs share) against the CPU's default Adam on the
    same gradients, within the tolerance tests/test_torch_mappo.py
    test_adam_steps_match_optax holds the CPU's to optax.adam (rtol 1e-6,
    atol 1e-7)."""
    cpu = Actor(12, 50, generator=torch.Generator().manual_seed(4))
    card = copy.deepcopy(cpu).to(cuda)
    opts = (make_adam(cpu, 1e-3), make_adam(card, 1e-3))
    assert opts[1].defaults["capturable"] and opts[1].defaults["fused"]
    assert not opts[0].defaults["capturable"]
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        for p_cpu, p_card in zip(cpu.parameters(), card.parameters()):
            grad = torch.randn(p_cpu.shape, generator=g)
            p_cpu.grad, p_card.grad = grad, grad.to(cuda)
        for opt in opts:
            opt.step()
    for a, b in zip(cpu.parameters(), card.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
def test_cpu_checkpoint_resumes_on_the_card_as_graphs(cuda, tmp_path):
    """A checkpoint written on the CPU (its Adam neither capturable nor
    fused) resumes on the card under --jit-repeats 2: the card's Adam keeps
    its capturable, fused settings with its step counts on the card, and
    the graphed block after the first runs (its replays counted)."""
    extra = ["--fused-updates"]
    ck = str(tmp_path / "ck")
    train(_tiny(2, extra), device="cpu", fused_collect=True, verbose=False,
          output_root=str(tmp_path / "cpu"), checkpoint_dir=ck)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    ts, _, log = train(_tiny(6, extra), device="cuda", fused_collect=True,
                       verbose=False, output_root=str(tmp_path / "card"),
                       checkpoint_dir=ck, resume=True, jit_repeats=2)
    torch.cuda.synchronize()
    for opt in (ts.actor_opt, ts.critic_opt):
        group = opt.param_groups[0]
        assert group["capturable"] and group["fused"]
        for st in opt.state.values():
            assert st["step"].device.type == "cuda"
            assert float(st["step"]) == 6 * 2  # 6 repeats x 2 epochs
    assert len(log.logs["mean_rews"]) == 6
    assert all(torch.isfinite(torch.tensor(log.logs[k])).all()
               for k in ("mean_rews", "actor", "critic"))
    # Repeats 2-3 an eager block, 4-5 a replayed graph: 4 collects.
    assert wrappers["fused_collect"].launches == 4
    assert wrappers["fused_actor_grad"].launches == 4 * 2
