"""Kernels (CUDA C++ under csrc/) and their plain PyTorch versions: the
fused collect, the fused bench rollout (over a data-parallel mesh:
``sharded.py``), the actor- and critic-gradient
kernels of the fused updates, and the returns kernel (``returns.py``);
``graphs.py`` holds CUDA graphs that count their kernels' launches.

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
from marlnav_tpu_torch.ops.fused_rollout import (
    fused_rollout_rows,
    make_fused_rollout,
    rollout_rows_reference,
)
from marlnav_tpu_torch.ops.sharded import make_sharded_fused_rollout
from marlnav_tpu_torch.ops.fused_update import (
    actor_grad,
    actor_grad_sums,
    actor_grad_uncollapsed,
    actor_grad_uncollapsed_sums,
    critic_grad,
    critic_grad_sums,
)
from marlnav_tpu_torch.ops.update_math import (
    actor_grad_sums_reference,
    actor_grad_sums_uncollapsed_reference,
    critic_grad_sums_reference,
)

__all__ = [
    "RowState",
    "actor_grad",
    "actor_grad_sums",
    "actor_grad_sums_reference",
    "actor_grad_sums_uncollapsed_reference",
    "actor_grad_uncollapsed",
    "actor_grad_uncollapsed_sums",
    "collect_rows_reference",
    "critic_grad",
    "critic_grad_sums",
    "critic_grad_sums_reference",
    "env_state_to_rows",
    "fused_collect_rows",
    "fused_rollout_rows",
    "make_fused_collect",
    "make_fused_rollout",
    "make_sharded_fused_rollout",
    "rollout_rows_reference",
    "rows_to_env_arrays",
    "rows_to_env_state",
]
