"""``correct`` comes out false when the timed path is broken, and for the
control: a whole run of each cell at a toy size on the CPU (the look for a
card skipped; the port's kernels' plain versions), with the cell's own
limits.

Faults, each planted in the program underneath the harness:

* a step that returns its state unchanged (Adam's step does nothing; the
  rollout returns the rows it was given);
* half of the batch left out and the mean taken over the rest (the
  gradient sums over the first half of the rows, doubled; the rollout
  steps the first half of the envs);
* an answer altered where it is produced (a reward of the collect or of
  the rollout);
* in the train cells, Adam's state lost between repeats (its moments and
  step count reset after each phase), which the next repeat would start
  from.

The exchange between chips does not exist in these one-chip cells.  The
control: the train cells with the program's ``bf16_updates``, the rollout
cell against the reference with its actor's operands in bfloat16.
"""

import pytest
import torch

from benchmark.control import control_kwargs
from benchmark.harness import runner

TRAIN = ("default.train", "curriculum.train", "obstacles17.train")
SIZES = {"default.train": {"traffic": {"envs": 8},
                           "model": {"buffer_len": 20, "batch_size": 20,
                                     "num_epochs": 3}},
         "curriculum.train": {"traffic": {"envs": 8, "block": 4},
                              "model": {"buffer_len": 20, "batch_size": 20,
                                        "num_epochs": 3}},
         "default.rollout": {"traffic": {"envs": 8, "steps": 20}},
         "obstacles17.train": {"traffic": {"envs": 8},
                               "model": {"buffer_len": 20, "batch_size": 20,
                                         "num_epochs": 3}}}


def _run(name, cpu_uniforms, **kwargs):
    return runner.run_cell(name, 2 ** 31 + 99, 0.05, False, "cpu", 0.0,
                           uniforms_fn=cpu_uniforms, sizes=SIZES[name],
                           **kwargs)


def _state_unchanged(monkeypatch, name):
    if name in TRAIN:
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        return
    from marlnav_tpu_torch.ops import fused_rollout

    real = fused_rollout.fused_rollout_rows

    def stuck(sm, rows, *args, **kw):
        return rows, real(sm, rows, *args, **kw)[1]

    monkeypatch.setattr(fused_rollout, "fused_rollout_rows", stuck)


def _half_batch(monkeypatch, name):
    if name in TRAIN:
        from marlnav_tpu_torch.ops import fused_update

        def halved(fn, first_row_arg, n_row_args):
            def run(*args, **kw):
                args = list(args)
                n = args[first_row_arg].shape[0]
                for i in range(first_row_arg, first_row_arg + n_row_args):
                    args[i] = args[i][:n // 2]
                return tuple(x * (n / (n // 2)) for x in fn(*args, **kw))
            return run

        monkeypatch.setattr(fused_update, "actor_grad_sums",
                            halved(fused_update.actor_grad_sums, 2, 4))
        monkeypatch.setattr(fused_update, "critic_grad_sums",
                            halved(fused_update.critic_grad_sums, 4, 3))
        return
    from marlnav_tpu_torch.ops import fused_rollout

    real = fused_rollout.fused_rollout_rows

    def half(sm, rows, *args, **kw):
        out, rewards = real(sm, rows, *args, **kw)
        p = rewards.shape[1] // 2
        for x, x0 in zip(out.fields(), rows.fields()):
            x[:, p:] = x0[:, p:]
        rewards[:, p:] = 0.0
        return out, rewards

    monkeypatch.setattr(fused_rollout, "fused_rollout_rows", half)


def _answer_altered(monkeypatch, name):
    from marlnav_tpu_torch.ops import fused_collect, fused_rollout

    module, fn = ((fused_collect, "fused_collect_rows") if name in TRAIN
                  else (fused_rollout, "fused_rollout_rows"))
    real = getattr(module, fn)

    def altered(*args, **kw):
        out = real(*args, **kw)
        rewards = out.rewards if name in TRAIN else out[1]
        rewards[0, 0] += 1.0
        return out

    monkeypatch.setattr(module, fn, altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            cpu_uniforms):
    fault(monkeypatch, name)
    result = _run(name, cpu_uniforms)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_adam_state_lost_between_repeats_is_not_correct(name, monkeypatch,
                                                        cpu_uniforms):
    real = torch.optim.Adam.step
    steps = SIZES[name]["model"]["num_epochs"]

    def step(self, closure=None):
        out = real(self, closure)
        for st in self.state.values():
            if int(st["step"]) % steps == 0:
                for x in st.values():
                    x.zero_()
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    result = _run(name, cpu_uniforms)
    assert not result["correct"], result["checks"]
    numbers = {k: c["value"] for k, c in result["checks"].items()}
    numbers.update(result["readings"])
    assert numbers["adam_v_gap"] > 0.5


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_is_not_correct(name, cpu_uniforms):
    kind = "train" if name in TRAIN else "rollout"
    result = _run(name, cpu_uniforms, **control_kwargs(kind))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_sound_run_is_correct(name, cpu_uniforms):
    assert _run(name, cpu_uniforms)["correct"]


def test_the_clip_look_follows_the_compared_repeats(cpu_uniforms):
    """``clip_look.py`` on the CPU: a line for each compared repeat, the
    sides of each phase's clip counted at every step, and the sound
    program at one with the float64 reference."""
    from benchmark import clip_look

    lines = clip_look.look("default.train", 2 ** 31 + 99, 1e-5, "cpu",
                           SIZES["default.train"], cpu_uniforms)
    steps = SIZES["default.train"]["model"]["num_epochs"]
    assert [line["repeat"] for line in lines] == [0, 1, 2]
    for line in lines:
        for phase in ("actor", "critic"):
            look = line[phase]
            assert len(look["sides_differ_f32_f64"]) == steps
            assert look["pairs"]["program_vs_f64"]["loss_gap_all_steps"] < 1e-5
            assert look["pairs"]["f32_vs_f64"]["worst_leaf"] < 1e-2


@pytest.mark.parametrize("name", TRAIN)
def test_faults_planted_in_the_reference_are_not_correct(name,
                                                         cpu_uniforms):
    """``control.py --fault-seeds``: the reference with each fault planted,
    in the program's place, fails the cell's limits."""
    from benchmark.control import fault_readings
    from benchmark.harness import spec
    from benchmark.reference import compare

    limits = spec.find_cell(name).limits()
    readings = fault_readings(name, 2 ** 31 + 99, "cpu", SIZES[name],
                              cpu_uniforms)
    for fault, numbers in readings.items():
        assert not compare.verdict(numbers, limits), (fault, numbers)
    assert readings["state_unchanged"]["adam_step_gap"] > 0
