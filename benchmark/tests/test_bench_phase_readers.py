"""The readers of the program's phase marks and launch span on stubbed
readings, as ``test_metric_readers_on_a_canned_table`` holds the device
trace's readers: each returns what ``utils.profiling.phase_ms()`` or
``span_summary()`` holds, and nothing where those are empty or where the
program has no such function."""

import pytest

from benchmark.harness import spec
from marlnav_tpu_torch.utils import profiling

PHASES = {"collect_phase_ms_per_repeat": "collect",
          "actor_phase_ms_per_repeat": "actor",
          "critic_phase_ms_per_repeat": "critic"}
READINGS = {"collect": 1.9, "actor": 7.2, "critic": 16.4, "tail": 0.01}
SPANS = {"marlnav.block.launch": {"count": 4, "ms": 66.0},
         "marlnav.collect": {"count": 1, "ms": 3.0}}


@pytest.mark.parametrize("name, want", [
    ("collect_phase_ms_per_repeat", 1.9),
    ("actor_phase_ms_per_repeat", 7.2),
    ("critic_phase_ms_per_repeat", 16.4),
    ("launch_host_ms_per_block", 66.0 / 4)])
def test_phase_readers_on_stubbed_readings(monkeypatch, name, want):
    monkeypatch.setattr(profiling, "phase_ms", lambda: dict(READINGS))
    monkeypatch.setattr(profiling, "span_summary", lambda: dict(SPANS))
    assert spec.metric_reader(name)(None) == pytest.approx(want)


@pytest.mark.parametrize("name", [*PHASES, "launch_host_ms_per_block"])
def test_phase_readers_report_nothing_without_readings(monkeypatch, name):
    monkeypatch.setattr(profiling, "phase_ms", dict)
    monkeypatch.setattr(profiling, "span_summary", dict)
    assert spec.metric_reader(name)(None) is None
    monkeypatch.setattr(profiling, "span_summary", lambda: {
        "marlnav.block.launch": {"count": 0, "ms": 0.0}})
    assert spec.metric_reader(name)(None) is None
    # A program without the marks or the span (before they existed).
    monkeypatch.delattr(profiling, "phase_ms")
    monkeypatch.delattr(profiling, "span_summary")
    assert spec.metric_reader(name)(None) is None
