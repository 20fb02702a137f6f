"""The bench rollout over a mesh's data index.

Port of ``marlnav_tpu/ops/sharded.py``: each data index rolls out its
share of the envs with the rollout kernel (``ops/fused_rollout.py``); no
rank talks to another during a rollout, and each rank's rewards stay on
it.  Each data index draws from its own stream: the kernel's seed is
``seed + (data index << 20)`` (``fused_collect.shard_seed``), as the JAX
package offsets each shard's by its axis index.  A tensor-parallel actor
is gathered whole first (one all-gather over its model group).
"""

from __future__ import annotations

from marlnav_tpu_torch.ops.fused_collect import shard_seed
from marlnav_tpu_torch.ops.fused_rollout import make_fused_rollout
from marlnav_tpu_torch.parallel.sharding import shard_rows
from marlnav_tpu_torch.parallel.tensor import gather_networks


def make_sharded_fused_rollout(env_params, init_cfg, normalizer_cfg,
                               scaler_cfg, num_steps: int, mesh,
                               deterministic_actions: bool = False):
    """Build ``rollout(rows, actor, seed, noise=None) -> (rows', rewards)``
    on ``mesh`` (a ``parallel.Mesh``), on its device.  ``rows`` is the
    whole run's ``RowState`` (r, P), the same on every rank, and ``noise``
    its uniforms (T, n_draws, P); the rank rolls out its data index's envs
    (P / num_data columns) and returns their final rows and (T, P /
    num_data) rewards.  Raises where P does not split over the data
    size."""
    roll = make_fused_rollout(env_params, init_cfg, normalizer_cfg,
                              scaler_cfg, num_steps, deterministic_actions,
                              device=mesh.device)

    def rollout(rows, actor, seed: int, noise=None):
        offset, count = mesh.env_slice(rows.px.shape[-1])
        if noise is not None:
            noise = noise[..., offset:offset + count].contiguous()
        (actor,) = gather_networks([actor])
        return roll(shard_rows(rows, mesh), actor,
                    shard_seed(seed, mesh.data_index), noise)

    return rollout
