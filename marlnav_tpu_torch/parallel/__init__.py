"""Data and tensor parallelism over ``torch.distributed``: the (data x
model) grid, the sharding layer and the split networks (port of
``marlnav_tpu/parallel/``)."""

from marlnav_tpu_torch.parallel.mesh import (Mesh, default_backend,
                                             init_distributed, make_mesh)
from marlnav_tpu_torch.parallel.sharding import (
    all_gather_envs,
    all_reduce_sum,
    check_replicated,
    gather_env_state,
    shard,
    shard_buffer,
    shard_env_state,
    shard_rows,
)

__all__ = [
    "Mesh",
    "all_gather_envs",
    "all_reduce_sum",
    "check_replicated",
    "default_backend",
    "gather_env_state",
    "init_distributed",
    "make_mesh",
    "shard",
    "shard_buffer",
    "shard_env_state",
    "shard_rows",
]
