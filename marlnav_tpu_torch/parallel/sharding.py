"""Which rows each rank holds, gathering them back, and the collectives.

Port of ``marlnav_tpu/parallel/sharding.py`` for the 'data' axis.  Every
per-env leaf (leading P axis of ``EnvState``, the P columns of a
``RowState``, axis 1 of a ``(T, P, ...)`` ``Buffer`` leaf) splits over the
data index, data index d holding envs ``[d * P/D, (d + 1) * P/D)`` for a
data size D; the networks and Adam states are replicated over the data
index (their split over the model index is ``parallel.tensor``'s).  Where
the JAX package lets XLA derive the collectives from shardings, the port
calls them itself, over the data group: a sum all-reduce of one flat
tensor (gradient sums, returns statistics, episode counters) and an
all-gather along the env axis (the faithful advantage pairing,
checkpoints).  Both run on the current stream, so a CUDA graph can hold
them (NCCL).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from marlnav_tpu_torch.parallel.mesh import Mesh

# EnvState fields with a leading env axis.
_ENV_LEAVES = ("states", "obstacles", "target", "step_num", "terminates",
               "reset_states")


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` (contiguous) over the data group in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return x


def all_gather_envs(x: torch.Tensor, mesh: Mesh,
                    dim: int = 0) -> torch.Tensor:
    """Every data index's ``x`` concatenated along ``dim`` in data order
    (over the data group): this rank's env slice back to the global
    layout."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.num_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts, dim)


def shard(x: torch.Tensor, mesh: Mesh, dim: int = 0,
          per_env: int = 1) -> torch.Tensor:
    """This rank's rows of ``x`` along its env axis ``dim`` (``per_env``
    entries an env there, e.g. A for a flattened (T, P*A) leaf), as a
    contiguous tensor."""
    offset, count = mesh.env_slice(x.shape[dim] // per_env)
    return x.narrow(dim, offset * per_env, count * per_env).contiguous()


def shard_env_state(state, mesh: Mesh):
    """This rank's envs of a global ``EnvState`` (counters and generator
    kept)."""
    return dataclasses.replace(state, **{
        name: shard(getattr(state, name), mesh) for name in _ENV_LEAVES
        if getattr(state, name) is not None})


def gather_env_state(state, mesh: Mesh):
    """The global ``EnvState`` from every rank's envs (a collective: every
    rank calls it).  Its counters and generator are kept: a collect leaves
    the counters summed over the ranks and every rank's generator in the
    same state (replicated, as the JAX package keeps them)."""
    return dataclasses.replace(state, **{
        name: all_gather_envs(getattr(state, name), mesh)
        for name in _ENV_LEAVES if getattr(state, name) is not None})


def shard_rows(rows, mesh: Mesh):
    """This rank's envs (columns) of a global ``RowState``."""
    return type(rows)(*(shard(x, mesh, dim=-1) for x in rows.fields()))


def shard_buffer(buffer, mesh: Mesh, num_agents: int):
    """This rank's envs of a global ``Buffer``: axis 1 of every leaf, the
    agents of an env kept together in the flattened (T, P*A) log-probs."""
    return type(buffer)(
        obs=shard(buffer.obs, mesh, 1), actions=shard(buffer.actions, mesh, 1),
        log_probs=shard(buffer.log_probs, mesh, 1, num_agents),
        values=shard(buffer.values, mesh, 1),
        returns=shard(buffer.returns, mesh, 1),
        done=shard(buffer.done, mesh, 1))


@torch.no_grad()
def check_replicated(modules, mesh: Mesh) -> None:
    """Raise on every rank unless the ranks hold the same networks (every
    rank builds them from the same seed; a difference would make the
    replicas drift apart): each replicated parameter of ``modules`` equal
    to rank 0's bit for bit, each tensor-parallel shard equal to its data
    column's first rank's (``parallel.tensor.split_dim``)."""
    from marlnav_tpu_torch.parallel.tensor import split_dim

    named = [(name, p.detach().reshape(-1)) for m in modules
             for name, p in m.named_parameters()]
    sharded = mesh.num_model > 1
    checks = (([x for n, x in named if not sharded
                or split_dim(n) is None], None, 0),
              ([x for n, x in named if sharded
                and split_dim(n) is not None], mesh.data_group,
               mesh.model_index))
    differs = 0
    for tensors, group, src in checks:
        if tensors:
            flat = torch.cat(tensors)
            ref = flat.clone()
            dist.broadcast(ref, src, group=group)
            differs += 0 if torch.equal(flat, ref) else 1
    differs = torch.tensor([min(differs, 1)], dtype=torch.int32,
                           device=named[0][1].device)
    dist.all_reduce(differs)
    if int(differs) != 0:
        raise RuntimeError(f"the networks differ between the ranks "
                           f"({int(differs)} of {mesh.world} differ from "
                           f"rank 0's or their column's first rank's)")
