"""The harness on the CPU: ``BENCHMARK.json`` against its files and the
contract's character rules, the metric readers on a canned profiler
table, the run without a card, and what the benchmark may import."""

import ast
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.harness.runner import Context
from benchmark.harness.trace import DeviceWork

HERE = spec.HERE
ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def _bench():
    return spec.benchmark_json()


def test_every_entry_resolves_to_its_files():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert os.path.exists(os.path.join(ROOT, bench["command"][1]))
    for work in bench["workloads"]:
        cell = spec.find_cell(work["name"], bench)
        driver = importlib.import_module(
            f"benchmark.harness.{cell.traffic['kind']}")
        assert callable(driver.Traffic) and callable(driver.check)
        assert set(cell.limits()) and cell.cell["trace_units"] >= 1
    for conf in bench["configs"]:
        assert conf["file"].startswith("benchmark/configs/")
        assert os.path.exists(os.path.join(ROOT, conf["file"]))
        assert any(w["config"] == conf["name"] for w in bench["workloads"])
    for metric in bench["per_layer"]:
        assert callable(spec.metric_reader(metric["name"]))
        assert metric["moves"] in {m["name"] for m in bench["end_to_end"]}


def test_configs_hold_every_value_the_program_runs_with():
    from benchmark.harness import inputs

    for conf in _bench()["configs"]:
        with open(os.path.join(ROOT, conf["file"])) as fh:
            config = json.load(fh)
        assert config["reduced"] == conf["reduced"] == []
        inputs.port_configs(config, 64)  # raises on a missing field


def test_names_units_and_text_follow_the_contract():
    bench = _bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert TEXT.match(entry[key]), entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for conf in bench["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
    for work in bench["workloads"]:
        assert set(work) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(work["traffic"]) and work["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {"setup_s"} <= {m["name"] for m in bench["end_to_end"]}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def _ctx():
    table = [
        ("void marlnav::update::tc_grad_kernel<marlnav::update::"
         "CriticHead<7>, 5>(marlnav::update::GradArgs)", 100, 0.0310),
        ("marlnav::update::actor_grad_kernel(marlnav::update::ActorArgs)",
         100, 0.0114),
        ("void marlnav::fused_collect_kernel<3>(...)", 2, 0.0034),
        ("void at::native::vectorized_elementwise_kernel<...>", 3000,
         0.0040),
        ("Memcpy DtoH (Device -> Pageable)", 2, 0.0001)]
    work = DeviceWork(table, busy_s=0.050, window_s=0.054,
                      idle_gaps=[["cudaGraphLaunch", 1e-4]])
    shapes = {"envs": 1024, "steps": 1000, "minibatch_steps": 999,
              "agents": 3, "obs": 12, "hidden": 50, "obstacles": 3,
              "actor_epochs": 50, "critic_epochs": 50, "minibatches": 1,
              "policy_mean": False}
    return Context(work, [0.001, 0.003], 2, shapes)


@pytest.mark.parametrize("name, want", [
    ("critic_grad_roofline_pct", 100 * 999 * 1024 * 152 / 3.35e12 / 3.1e-4),
    ("actor_grad_roofline_pct", 100 * 3 * 999 * 1024 * 64 / 3.35e12 / 1.14e-4),
    ("collect_roofline_pct", 100 * 1024 * 1000 * 185 / 3.35e12 / 1.7e-3),
    ("train_mfu_pct", 100 * 2 * 1314.3077888e9 / 0.054 / 495e12),
    ("device_idle_pct.train", 100 * (1 - 0.050 / 0.054)),
    ("host_ms_per_block", 2.0),
    ("glue_ms_per_repeat", 1e3 * 0.0041 / 2),
    ("glue_kernels_per_repeat", 3002 / 2)])
def test_metric_readers_on_a_canned_table(name, want):
    assert spec.metric_reader(name)(_ctx()) == pytest.approx(want, rel=2e-3)


def test_the_glue_readers_leave_the_check_s_own_kernels_out():
    ctx = _ctx()
    ctx.harness_kernels, ctx.harness_s = 5, 2e-5
    assert spec.metric_reader("glue_kernels_per_repeat")(ctx) == 3002 / 2 - 5
    assert spec.metric_reader("glue_ms_per_repeat")(ctx) == pytest.approx(
        1e3 * (0.0041 / 2 - 2e-5))


def test_a_reader_that_finds_nothing_returns_nothing():
    ctx = _ctx()
    ctx.work.table = []
    for name in ("critic_grad_roofline_pct", "actor_grad_roofline_pct",
                 "collect_roofline_pct", "rollout_roofline_pct"):
        assert spec.metric_reader(name)(ctx) is None
    ctx.collect_s = 1.7e-3
    assert spec.metric_reader("collect_roofline_pct")(ctx) == pytest.approx(
        100 * 1024 * 1000 * 185 / 3.35e12 / 1.7e-3, rel=2e-3)


CMD = [sys.executable, "benchmark/run.py", "--workload", "default.train",
       "--seed", "1", "--seconds", "1", "--trace", "0"]


def test_a_run_without_the_card_exits_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and run.stdout == ""


def test_a_run_from_the_benchmark_alone_exits_and_prints_no_result(
        tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/ (no
    program) a run exits non-zero with nothing on stdout."""
    cmd = CMD
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and run.stdout == ""


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in _sources():
        found = set(_imports(path)) & {"jax", "jaxlib", "flax",
                                       "marlnav_tpu"}
        assert not found, (path, found)
    for path in _sources("reference"):
        assert "marlnav_tpu_torch" not in set(_imports(path)), path
    from benchmark.harness.runner import forbidden_modules

    assert set(forbidden_modules()) <= {"jax", "jaxlib", "flax"}


EXACT = ("rows_gap", "counts_gap", "mean_rew_gap", "adam_step_gap")


def test_every_train_cell_holds_its_exact_numbers_at_0():
    """The env rows, episode counts, mean return and Adam's step count are
    computed alike on both sides: no train cell may loosen them."""
    cells = [spec.find_cell(w["name"]) for w in _bench()["workloads"]]
    train = [c for c in cells if c.traffic["kind"] == "train"]
    assert train
    for cell in train:
        limits = cell.limits()
        exact = {k: limits.get(k) for k in EXACT}
        assert exact == dict.fromkeys(EXACT, 0.0), (cell.name, exact)
