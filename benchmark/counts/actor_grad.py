"""Work of the actor's gradient kernel (through its affine operator) on N
agent rows of F observations.  A row: z = A x + c, 8F + 4; the PPO chain,
91; the sums g_z x^T and g_z, 8F + 4; the loss sum, 1: 16F + 100
operations.  Bytes: each row read once (observations, action, log-prob,
advantage: 4F + 16), the operator read and the sums written once."""

from benchmark.counts import peaks


def ops(n_rows: int, obs: int) -> int:
    return n_rows * (16 * obs + 100)


def nbytes(n_rows: int, obs: int) -> int:
    return n_rows * (4 * obs + 16) + 4 * (4 * obs + 4) + 4 * (4 * obs + 5)


PEAK = peaks.TF32_FLOPS
