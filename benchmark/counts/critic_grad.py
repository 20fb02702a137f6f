"""Work of the critic's gradient kernel on N rows of In = A F inputs and H
hidden units.  A row: W1 x + b1 and the ReLU, 2 In H + 2H; v, 2H + 1; the
loss chain, 27; g_pre = w2 g_v (h > 0), 3H; dW2, 2H; db1, H; dW1, 2 In H;
the loss and db2 sums, 2: 4 In H + 10H + 30 operations.  Bytes: each row
read once (its inputs, old value and return, 4 In + 8), the weights read
and the sums written once."""

from benchmark.counts import peaks


def ops(n_rows: int, n_in: int, hidden: int) -> int:
    return n_rows * (4 * n_in * hidden + 10 * hidden + 30)


def nbytes(n_rows: int, n_in: int, hidden: int) -> int:
    n_par = hidden * n_in + 2 * hidden + 1
    return n_rows * (4 * n_in + 8) + 4 * (2 * n_par + 1)


PEAK = peaks.TF32_FLOPS
