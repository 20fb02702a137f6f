"""The port's training loop and CLI on the CPU, its device rule, and the
import rule that keeps the port independent of the JAX package."""

import ast
import glob
import os
import sys

import numpy as np
import pytest
import torch

from marlnav_tpu_torch.__main__ import build_parser, cli
from marlnav_tpu_torch.config import resolve_run_config
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.train import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "-np", "8", "-bl", "20", "-bs", "20", "-ne", "2",
        "-nt", "320", "-se", "3"]  # 2 repeats


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_cli_training_artifacts(tmp_path, monkeypatch, fused):
    """The artifact set of tests/test_cli_and_io.py, with and without
    --fused-collect (on the CPU the fused collect runs its plain version
    and launches no kernel)."""
    monkeypatch.chdir(tmp_path)
    before = fc.fused_collect_rows.launches
    cli(TINY + (["--fused-collect"] if fused else []))
    assert fc.fused_collect_rows.launches == before
    weights = sorted(glob.glob(str(tmp_path / "weights" / "*_actor.npz")))
    assert len(weights) == 1
    logs = {os.path.basename(p).split("_", 1)[1]
            for p in glob.glob(str(tmp_path / "logs" / "*"))}
    assert logs == {"mean_rews.csv", "act_loss.csv", "cri_loss.csv",
                    "epi_stats.csv", "params.json"}
    plots = {os.path.basename(p).split("_", 1)[1]
             for p in glob.glob(str(tmp_path / "plots" / "*"))}
    assert plots == {"mean_rews.png", "act_loss.png", "cri_loss.png",
                     "epi_stats.png"}
    # 2 repeats x 2 epochs x 1 minibatch = 4 loss rows; 2 rollout rows.
    stem = os.path.basename(weights[0]).replace("_actor.npz", "")
    assert len((tmp_path / "logs" / f"{stem}_act_loss.csv").read_text()
               .strip().splitlines()) == 1 + 4
    rews = (tmp_path / "logs" / f"{stem}_mean_rews.csv").read_text()
    assert np.isfinite([float(v) for v in rews.split()[1:]]).all()
    with np.load(weights[0]) as w:
        assert w["fc1.w"].shape == (12, 50)  # the JAX package's layout


def test_train_is_deterministic_per_seed(tmp_path):
    """The same seed gives the same run; the fused route on the CPU uses
    the kernel seeds base_seed + repeat."""
    cfg = resolve_run_config(build_parser().parse_args(TINY))
    runs = [train(cfg, device="cpu", fused_collect=True, verbose=False,
                  output_root=str(tmp_path / str(i)))[2].logs
            for i in range(2)]
    assert runs[0]["mean_rews"] == runs[1]["mean_rews"]
    assert runs[0]["actor"] == runs[1]["actor"]


@pytest.mark.parametrize("bs", [20, 5], ids=["full-batch", "sliced"])
def test_cli_fused_updates(tmp_path, monkeypatch, bs):
    """--fused-collect --fused-updates on the CPU runs the kernels' plain
    versions (no launch), for the full batch and for -bs < -bl, and logs
    one loss per epoch and minibatch."""
    from marlnav_tpu_torch.ops import fused_update as fu

    monkeypatch.chdir(tmp_path)
    argv = TINY.copy()
    argv[argv.index("-bs") + 1] = str(bs)
    before = (fc.fused_collect_rows.launches, fu.actor_grad_sums.launches,
              fu.critic_grad_sums.launches)
    cli(argv + ["--fused-collect", "--fused-updates"])
    assert (fc.fused_collect_rows.launches, fu.actor_grad_sums.launches,
            fu.critic_grad_sums.launches) == before
    (log,) = glob.glob(str(tmp_path / "logs" / "*_act_loss.csv"))
    rows = open(log).read().strip().splitlines()[1:]
    # 2 repeats x 2 epochs x (20 // bs) minibatches
    assert len(rows) == 2 * 2 * (20 // bs)
    assert np.isfinite([float(v) for r in rows for v in r.split(",")]).all()


@pytest.mark.parametrize("flag", [
    ["--num-data", "2"], ["--num-model", "2"], ["--multihost"],
    ["--num-data", "1"], ["--num-model", "4"],
    ["--multihost", "--num-data", "1"], ["--allow-interpret"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        cli(TINY + flag)


def test_parser_matches_jax_package():
    """Every flag of the JAX package's parser exists here with the same
    default; the port adds --device."""
    from marlnav_tpu.__main__ import build_parser as j_build_parser

    j_args = vars(j_build_parser().parse_args([]))
    t_args = vars(build_parser().parse_args([]))
    assert set(t_args) - set(j_args) == {"device"}
    assert {k: t_args[k] for k in j_args} == j_args
    assert t_args["device"] == "cuda"


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = resolve_run_config(build_parser().parse_args(TINY))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train(cfg, output_root=str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli(TINY[2:])  # no --device: the default, cuda


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """Neither the port, nor chip_smoke.py and the card tests (tests_cuda/)
    import jax, optax, orbax or the JAX package, not even lazily inside a
    function."""
    files = glob.glob(os.path.join(ROOT, "marlnav_tpu_torch", "**", "*.py"),
                      recursive=True) + glob.glob(
        os.path.join(ROOT, "tests_cuda", "*.py")) + [
        os.path.join(ROOT, "chip_smoke.py")]
    assert any("tests_cuda" in path for path in files)
    assert len(files) > 15
    banned = ("jax", "optax", "orbax", "marlnav_tpu")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in banned, f"{path} imports {name}"


def test_artifacts_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed, training writes every CSV, JSON
    and weight artifact, leaves the PNG plots out and says so."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    cfg = resolve_run_config(build_parser().parse_args(TINY))
    train(cfg, device="cpu", verbose=False, output_root=str(tmp_path))
    assert "PNG plots are left out" in capsys.readouterr().out
    assert not os.listdir(tmp_path / "plots")
    assert len(os.listdir(tmp_path / "logs")) == 5
    assert len(os.listdir(tmp_path / "weights")) == 2


@pytest.mark.parametrize("case", [
    ("sliced", 5, ["--fused-collect"], {}, "uncollapsed"),
    ("staged-full-batch", 20, [], {}, "uncollapsed"),
    ("tiled", 20, ["--fused-collect"], {}, "affine"),
    ("tiled-off", 20, ["--fused-collect"], {"MARLNAV_TILED_UPDATES": "off"},
     "uncollapsed")], ids=lambda c: c[0])
def test_actor_layout_routing(tmp_path, monkeypatch, case):
    """MARLNAV_ACTOR_LAYOUT=packed takes the actor gradient through the
    un-collapsed wrapper wherever the JAX package runs its staged actor
    kernel (-bs < -bl, or no --fused-collect, or MARLNAV_TILED_UPDATES
    off), and through the affine one on the tiled route (--fused-collect,
    full batch), where the JAX actor is always affine."""
    from marlnav_tpu_torch.ops import fused_update as fu

    _, bs, flags, env, want = case
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MARLNAV_ACTOR_LAYOUT", "packed")
    monkeypatch.delenv("MARLNAV_TILED_UPDATES", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"affine": 0, "uncollapsed": 0}
    for key, name in (("affine", "actor_grad_sums"),
                      ("uncollapsed", "actor_grad_uncollapsed_sums")):
        def spy(*args, _key=key, _fn=getattr(fu, name)):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(fu, name, spy)
    argv = TINY.copy()
    argv[argv.index("-bs") + 1] = str(bs)
    cli(argv + flags + ["--fused-updates"])
    # 2 repeats x 2 epochs x (20 // bs) minibatches
    assert calls == {want: 2 * 2 * (20 // bs),
                     ({"affine", "uncollapsed"} - {want}).pop(): 0}
