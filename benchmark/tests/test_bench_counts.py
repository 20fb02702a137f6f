"""The benchmark's counts of operations, bytes and model FLOPs, pinned to
the figures PERF.md's kernel table gives."""

import pytest

from benchmark.counts import (actor_grad, collect, critic_grad, model_flops,
                              peaks, rollout)


def test_rows_and_env_steps():
    assert critic_grad.ops(1, 36, 50) == 7730
    assert actor_grad.ops(1, 12) == 292
    assert collect.ops_per_env_step(3) == 1830
    assert rollout.ops_per_env_step(3, False) == 1799
    assert rollout.ops_per_env_step(3, True) == 1493
    assert critic_grad.nbytes(1000, 36, 50) - critic_grad.nbytes(0, 36, 50) \
        == 1000 * (4 * 36 + 8)
    assert actor_grad.nbytes(10, 12) - actor_grad.nbytes(0, 12) == 10 * 64
    # 185 bytes of buffer an env-step at O 3, besides the rows.
    assert collect.nbytes(1, 2, 3) - collect.nbytes(1, 1, 3) == 185
    assert rollout.nbytes(1, 2, 3) - rollout.nbytes(1, 1, 3) == 4


@pytest.mark.parametrize("cell, gflop", [
    ((1024, 1000, 3, 12, 50, 50, 50), 1314.3077888),
    ((4096, 200, 3, 12, 50, 10, 10), 215.8743552)])
def test_model_flops_of_a_repeat(cell, gflop):
    assert model_flops.train_repeat(*cell) == pytest.approx(gflop * 1e9,
                                                            rel=1e-12)


def test_rollout_model_flops_and_bounds():
    assert model_flops.rollout_env_step(3, 12, 50) == 4800
    # The rollout at the bench's shape is bound by its operations: 220 us.
    t = peaks.least_seconds(rollout.ops(16384, 500, 3, False),
                            rollout.nbytes(16384, 500, 3), rollout.PEAK)
    assert t == pytest.approx(220.0e-6, rel=2e-3)
    # The critic at (1024, 999) is bound by its bytes: ~46 us.
    t = peaks.least_seconds(critic_grad.ops(999 * 1024, 36, 50),
                            critic_grad.nbytes(999 * 1024, 36, 50),
                            critic_grad.PEAK)
    assert t == pytest.approx(999 * 1024 * 152 / 3.35e12, rel=1e-3)
