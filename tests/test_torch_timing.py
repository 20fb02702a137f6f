"""The port's timing helpers (``marlnav_tpu_torch/timing.py``) on the CPU:
the ptxas report reader, a step kernel's inputs, one training repeat, and
the comparison tool's refusals.  The timers themselves need the card;
``chip_smoke.py`` runs them there."""

import os
import subprocess
import sys

import pytest
import torch

from marlnav_tpu_torch import timing
from marlnav_tpu_torch.ops import fused_collect as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["-np", "4", "-bl", "8", "-nt", "32", "-ne", "2", "-bs", "8"]

LOG = """\
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Used 40 registers
"""


def test_ptxas_summary_reads_each_entry_function():
    assert timing.ptxas_summary(LOG) == [
        "  _Z1aPf: 32 bytes stack frame, 0 bytes spill stores, 0 bytes "
        "spill loads",
        "  _Z1aPf: Used 80 registers, used 1 barriers",
        "  _Z1bPf: Used 40 registers"]
    assert timing.ptxas_summary("no ptxas here") == []


@pytest.mark.parametrize("o", [3, 9])
@pytest.mark.parametrize("tame", [False, True])
def test_step_case_makes_a_step_kernels_inputs(o, tame):
    """p envs of o obstacles, an actor operator over the obs width; the same
    seed gives the same case, and ``tame`` shrinks the operator."""
    sm, rows, a_comp, c_comp = timing.step_case(7, o, tame=tame,
                                                device="cpu")
    assert (sm.o, sm.a) == (o, 3)
    assert all(x.shape[-1] == 7 for x in rows.fields())
    assert a_comp.shape == (4, sm.obs_size) and c_comp.shape == (4,)
    again = timing.step_case(7, o, tame=tame, device="cpu")
    for x, y in zip((*rows.fields(), a_comp, c_comp),
                    (*again[1].fields(), again[2], again[3])):
        assert torch.equal(x, y)
    if tame:
        wild = timing.step_case(7, o, device="cpu")[2]
        assert a_comp[:2].abs().max() < 1e-2 * wild[:2].abs().max()
    out = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 3, 4)
    assert torch.isfinite(out.obs).all() and out.obs.shape[-1] == sm.obs_size


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "autograd"])
def test_training_repeat_trains_and_repeats_itself(tmp_path, fused):
    """Two repeats built afresh (9 obstacles, the run-time width's path)
    give the same weights bit for bit, and the weights move."""
    runs = []
    for _ in range(2):
        rep = timing.training_repeat(SMALL + ["-no", "9"], str(tmp_path),
                                     fused, "cpu")
        assert rep.cfg.model.fused_updates
        before = [p.clone() for p in rep.ts.actor.parameters()]
        metrics = rep.run()[2]
        assert torch.isfinite(metrics.mean_rew).all()
        after = list(rep.ts.actor.parameters())
        assert any(not torch.equal(x, y) for x, y in zip(before, after))
        runs.append([p.detach().clone() for p in after]
                    + [p.detach().clone() for p in rep.ts.critic.parameters()])
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def _timing_cli(*args, cwd=ROOT, safe_path=False):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = ([sys.executable, "-P", timing.__file__] if safe_path
           else [sys.executable, "-m", "marlnav_tpu_torch.timing"])
    return subprocess.run(cmd + list(args), cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_timing_cli_refuses_without_a_card_or_another_checkout(tmp_path):
    """No checkout given: a usage error.  No card: exit non-zero, no
    result."""
    assert _timing_cli().returncode == 2
    proc = _timing_cli(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_timing_child_refuses_a_package_of_another_checkout(tmp_path):
    """A child process times the checkout it runs in: where the package on
    its path lies elsewhere, it exits before timing anything."""
    proc = _timing_cli("--time", str(tmp_path), cwd=str(tmp_path),
                       safe_path=True)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "not from" in proc.stderr
