"""Kernels: the fused collect (CUDA C++ under csrc/) and its plain version.

Importing this package builds nothing; a kernel is compiled with ``nvcc``
at its first launch (ops/_build.py).
"""

from marlnav_tpu_torch.ops.fused_collect import (
    RowState,
    collect_rows_reference,
    env_state_to_rows,
    fused_collect_rows,
    make_fused_collect,
    rows_to_env_arrays,
    rows_to_env_state,
)

__all__ = [
    "RowState",
    "collect_rows_reference",
    "env_state_to_rows",
    "fused_collect_rows",
    "make_fused_collect",
    "rows_to_env_arrays",
    "rows_to_env_state",
]
