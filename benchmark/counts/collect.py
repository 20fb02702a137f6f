"""Work of the collect kernel (the training rollout, 3 agents, O
obstacles, F = 6 + 2 O) over T steps of P envs.  Operations an env-step,
each mul, add, compare, select, sqrt, divide or transcendental one:
3 (3 + O) geom calls of 44; the actor 3 (8F + 63); dynamics 144; rewards
and done 242 + 30 O; the reset blend 47 + 12 O; the step counter 2
(Philox's integer work is not counted): 1,830 at O 3.  Bytes: the buffer
written once (observations, actions, log-probs, reward: 4 (A F + 3A + 1),
and the done byte: 185 at O 3), the rows read and written, the operator
read."""

from benchmark.counts import peaks

AGENTS = 3


def ops_per_env_step(obstacles: int) -> int:
    f = 6 + 2 * obstacles
    return (3 * (3 + obstacles) * 44 + 3 * (8 * f + 63) + 144
            + (242 + 30 * obstacles) + (47 + 12 * obstacles) + 2)


def row_count(obstacles: int) -> int:
    """Rows of the state: 5 an agent, 2 an obstacle, target, counters."""
    return 5 * AGENTS + 2 * obstacles + 4


def ops(envs: int, steps: int, obstacles: int) -> int:
    return envs * steps * ops_per_env_step(obstacles)


def nbytes(envs: int, steps: int, obstacles: int) -> int:
    f = 6 + 2 * obstacles
    a = AGENTS
    return (steps * envs * (4 * (a * f + 2 * a + a + 1) + 1)
            + 2 * row_count(obstacles) * envs * 4 + 4 * (4 * f + 4) + 3 * 4)


PEAK = peaks.FP32_FLOPS
