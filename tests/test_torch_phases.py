"""The phase marks and host spans of ``marlnav_tpu_torch/utils/profiling.py``
on the CPU.

``annotate`` sums host time by name only while a ``torch.profiler``
session records; a training run shows its ``marlnav.*`` phase ranges in a
trace; ``phase_ms()`` is empty on the CPU, where no block stamps, and the
benchmark's readers of it report nothing; a run gives the same weights,
Adam states, env state and logs with marks on and off, on both collect
routes; ``PhaseMarks.read`` turns stamps into milliseconds a repeat.  The
stamps themselves run on the card (``tests_cuda/test_cuda_phases.py``).
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from marlnav_tpu_torch.__main__ import build_parser
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.train import train
from marlnav_tpu_torch.utils import annotate, profiling

PHASES = ("collect", "actor", "critic", "tail")
READERS = ("collect_phase_ms_per_repeat", "actor_phase_ms_per_repeat",
           "critic_phase_ms_per_repeat", "launch_host_ms_per_block")


def _count(name):
    return profiling.span_summary().get(name, {"count": 0, "ms": 0.0})


def test_annotate_sums_host_time_only_while_a_profiler_records():
    name = "marlnav.test.span"
    before = _count(name)
    with annotate(name):
        time.sleep(0.002)
    assert _count(name) == before
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with annotate(name):
                time.sleep(0.002)
    during = _count(name)
    assert during["count"] == before["count"] + 3
    assert during["ms"] - before["ms"] >= 3 * 2.0
    with annotate(name):
        pass
    assert _count(name) == during


def _cfg(repeats, *extra):
    return resolve_run_config(build_parser().parse_args(
        ["--device", "cpu", "-np", "8", "-bl", "20", "-bs", "20", "-ne", "2",
         "-se", "3", "-nt", str(repeats * 8 * 20), *extra]))


def _run(tmp_path, fused, name, marks):
    profiling.set_phase_marks(marks)
    try:
        return train(_cfg(3, "--fused-updates" if fused else "--use-gae"),
                     device="cpu", fused_collect=fused, verbose=False,
                     output_root=str(tmp_path / name), jit_repeats=2)
    finally:
        profiling.set_phase_marks(True)


def _tensors(run):
    ts, state, _ = run
    out = [*ts.actor.state_dict().values(), *ts.critic.state_dict().values()]
    for opt in (ts.actor_opt, ts.critic_opt):
        for st in opt.state_dict()["state"].values():
            out += [st[k] for k in sorted(st)]
    if isinstance(state, fc.RowState):
        return out + state.fields()
    return out + [state.states, state.obstacles, state.target,
                  state.step_num, state.terminates]


@pytest.mark.parametrize("route", ["plain", "fused-collect"])
def test_runs_equal_with_phase_marks_on_and_off(tmp_path, route):
    """A block of 2 and a repeat alone through ``train_many``: weights,
    Adam states, env state, losses and metrics bit for bit."""
    fused = route == "fused-collect"
    on = _run(tmp_path, fused, "on", True)
    off = _run(tmp_path, fused, "off", False)
    for x, y in zip(_tensors(on), _tensors(off), strict=True):
        assert torch.equal(x, y)
    assert on[2].logs == off[2].logs
    assert len(on[2].logs["mean_rews"]) == 3


def test_a_training_trace_shows_the_phase_ranges(tmp_path):
    counts = {p: _count("marlnav." + p)["count"] for p in PHASES}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(_cfg(3, "--fused-updates"), device="cpu", fused_collect=True,
              verbose=False, output_root=str(tmp_path), jit_repeats=2)
    names = {e.name for e in prof.events()}
    assert {"marlnav." + p for p in PHASES} <= names
    gained = {p: _count("marlnav." + p)["count"] - counts[p] for p in PHASES}
    # Three repeats, in an eager block of 2 and a block of 1.
    assert gained == {"collect": 3, "actor": 3, "critic": 3, "tail": 2}


def test_phase_ms_is_empty_on_the_cpu_and_the_readers_report_nothing(
        tmp_path):
    from benchmark.harness import spec

    train(_cfg(2, "--fused-updates"), device="cpu", fused_collect=True,
          verbose=False, output_root=str(tmp_path), jit_repeats=2)
    assert profiling.phase_ms() == {}
    with profiling.phase_block("cpu") as marks:
        assert marks is None
    # No graph replays on the CPU, so no launch span either.
    for name in READERS:
        assert spec.metric_reader(name)(None) is None


def test_phase_marks_read_milliseconds_a_repeat():
    """Two repeats' stamps (ns): each phase's sum over its runs, over the
    block's repeats, and the wall from the first stamp to the last."""
    marks = profiling.PhaseMarks(torch.device("cpu"))
    t = 1_000_000  # 1 ms
    spans = {"collect": [(0, 2 * t), (10 * t, 12 * t)],
             "actor": [(2 * t, 5 * t), (12 * t, 15 * t)],
             "critic": [(5 * t, 10 * t), (15 * t, 20 * t)],
             "tail": [(20 * t, 21 * t)]}
    for name, pairs in spans.items():
        for start, end in pairs:
            marks.take(name).copy_(torch.tensor([start, end]))
    ms, wall = marks.read()
    assert ms == pytest.approx({"collect": 2.0, "actor": 3.0,
                                "critic": 5.0, "tail": 0.5})
    assert wall == pytest.approx(10.5)
    assert sum(ms.values()) == pytest.approx(wall)
    # A second block reuses the pairs it has.
    marks.ran.clear()
    first = marks.take("collect")
    assert first is marks.pairs["collect"][0]
    assert profiling.PhaseMarks(torch.device("cpu")).read() == ({}, 0.0)
