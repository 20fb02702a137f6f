"""The phase marks (``utils/profiling.py``) inside the block runner's CUDA
graphs, on the card, at the default configuration (1024 envs x 1000
steps, 50 + 50 full-batch epochs, the fused collect and updates).

A graph captured with marks replays bit for bit as the same graph captured
without them; the phases of a replay and its tail add up to the replay's
wall between its first stamp and its last; each phase takes at least the
time its own kernels take in the profiler's trace of the same replay.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from marlnav_tpu_torch.__main__ import build_parser
from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import env_state_to_rows, make_fused_collect
from marlnav_tpu_torch.train import _Blocks, tiled_route, uncollapsed_actor
from marlnav_tpu_torch.utils import profiling
from marlnav_tpu_torch.utils.seeding import make_generator

BLOCK = 2


def _blocks(device, marks: bool):
    """A block runner of BLOCK repeats after its eager block and its first
    graphed block, the graph captured with marks on or off."""
    cfg = resolve_run_config(build_parser().parse_args(
        ["-np", "1024", "-nt", str(1024 * 1000 * 4 * BLOCK), "-se", "5",
         "--fused-updates"]))
    m = cfg.model
    mappo = make_mappo(m, make_env(cfg.env, cfg.init, device),
                       cfg.normalizer, cfg.scaler, uncollapsed_actor(m, True),
                       tiled_route(m, True))
    ts, state = mappo.init(make_generator(5, device))
    fc = make_fused_collect(m, cfg.env, cfg.init, cfg.normalizer, cfg.scaler)
    seeds = torch.zeros(BLOCK, dtype=torch.int32, device=device)
    offsets = torch.arange(BLOCK, dtype=torch.int32, device=device)
    blocks = _Blocks(mappo, ts, None,
                     lambda ts_, rows, i: fc(ts_, rows, seeds[i]), seeds,
                     offsets, 77, BLOCK, pipeline=False)
    rows, _ = blocks.eager(env_state_to_rows(state), 0, BLOCK)
    profiling.set_phase_marks(marks)
    try:
        rows, _ = blocks.graphed(rows, BLOCK)
    finally:
        profiling.set_phase_marks(True)
    return blocks, rows


def _state(blocks, rows, out):
    ts = blocks.ts
    tensors = [*rows.fields(), out, *ts.actor.parameters(),
               *ts.critic.parameters()]
    for opt in (ts.actor_opt, ts.critic_opt):
        for st in opt.state.values():
            tensors += [st[k] for k in sorted(st)]
    return [x.detach().clone() for x in tensors]


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    device = torch.device("cuda")
    out = {}
    for marks in (True, False):
        blocks, rows = _blocks(device, marks)
        rows, packed = blocks.graphed(rows, 2 * BLOCK)
        torch.cuda.synchronize()
        out[marks] = (blocks, _state(blocks, rows, packed))
    return out


@pytest.mark.cuda
def test_marked_graph_replays_as_the_unmarked_one(cuda, runs):
    assert runs[True][0].marks is not None and runs[False][0].marks is None
    for x, y in zip(runs[True][1], runs[False][1], strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_phases_add_up_to_the_replay_wall(cuda, runs):
    blocks = runs[True][0]
    blocks.graphed(blocks.static_state, 3 * BLOCK)
    ms, wall = blocks.marks.read()
    assert set(ms) == {"collect", "actor", "critic", "tail"}
    assert profiling.phase_ms() == ms
    assert all(v > 0 for v in ms.values())
    assert abs(sum(ms.values()) - wall) <= 0.03 * wall, (ms, wall)


@pytest.mark.cuda
def test_each_phase_holds_its_own_kernels(cuda, runs):
    blocks = runs[True][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blocks.graphed(blocks.static_state, 4 * BLOCK)
        torch.cuda.synchronize()
    ms = profiling.phase_ms()
    kernel_ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) * 1e-3 / BLOCK

    def own(*parts):
        """ms a repeat of the kernels whose name holds every one of
        ``parts``."""
        return sum(v for n, v in kernel_ms.items()
                   if all(p in n for p in parts))

    actor, critic = own("actor_grad_kernel"), own("tc_grad_kernel",
                                                   "CriticHead")
    assert actor > 0 and critic > 0 and own("phase_stamp") > 0
    assert ms["actor"] >= actor
    assert ms["critic"] >= critic
    assert ms["collect"] >= own("fused_collect") + own("returns_kernel")
