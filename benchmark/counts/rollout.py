"""Work of the rollout kernel over T steps of P envs: the collect's step
without the log-probs (3 agents x 9) and without the done flag and the
counters (4): 1,799 operations an env-step at O 3 with sampled actions.
With the policy mean it also skips, an agent, the operator's two variance
rows (4F), two softplus, Box-Muller and the sample (4F + 54): 1,493.
Bytes: the rewards written once (4 an env-step), the rows read and
written, the operator read."""

from benchmark.counts import collect, peaks


def ops_per_env_step(obstacles: int, deterministic: bool) -> int:
    f = 6 + 2 * obstacles
    return (collect.ops_per_env_step(obstacles) - 3 * 9 - 4
            - (3 * (4 * f + 54) if deterministic else 0))


def ops(envs: int, steps: int, obstacles: int, deterministic: bool) -> int:
    return envs * steps * ops_per_env_step(obstacles, deterministic)


def nbytes(envs: int, steps: int, obstacles: int) -> int:
    f = 6 + 2 * obstacles
    return (steps * envs * 4 + 2 * collect.row_count(obstacles) * envs * 4
            + 4 * (4 * f + 4))


PEAK = peaks.FP32_FLOPS
