"""Which rows each rank holds, gathering them back, and the collectives.

Port of ``marlnav_tpu/parallel/sharding.py`` for the 'data' axis.  Every
per-env leaf (leading P axis of ``EnvState``, the P columns of a
``RowState``, axis 1 of a ``(T, P, ...)`` ``Buffer`` leaf) splits over the
ranks, rank r holding envs ``[r * P/world, (r + 1) * P/world)``; the
networks and Adam states are replicated.  Where the JAX package lets XLA
derive the collectives from shardings, the port calls them itself: a sum
all-reduce of one flat tensor (gradient sums, returns statistics, episode
counters) and an all-gather along the env axis (the faithful advantage
pairing, checkpoints).  Both run on the current stream, so a CUDA graph
can hold them (NCCL).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from marlnav_tpu_torch.parallel.mesh import DataMesh

# EnvState fields with a leading env axis.
_ENV_LEAVES = ("states", "obstacles", "target", "step_num", "terminates",
               "reset_states")


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``x`` (contiguous) over the ranks in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def all_gather_envs(x: torch.Tensor, mesh: DataMesh,
                    dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: this
    rank's env slice back to the global layout."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim)


def shard(x: torch.Tensor, mesh: DataMesh, dim: int = 0,
          per_env: int = 1) -> torch.Tensor:
    """This rank's rows of ``x`` along its env axis ``dim`` (``per_env``
    entries an env there, e.g. A for a flattened (T, P*A) leaf), as a
    contiguous tensor."""
    offset, count = mesh.env_slice(x.shape[dim] // per_env)
    return x.narrow(dim, offset * per_env, count * per_env).contiguous()


def shard_env_state(state, mesh: DataMesh):
    """This rank's envs of a global ``EnvState`` (counters and generator
    kept)."""
    return dataclasses.replace(state, **{
        name: shard(getattr(state, name), mesh) for name in _ENV_LEAVES
        if getattr(state, name) is not None})


def gather_env_state(state, mesh: DataMesh):
    """The global ``EnvState`` from every rank's envs (a collective: every
    rank calls it).  Its counters and generator are kept: a collect leaves
    the counters summed over the ranks and every rank's generator in the
    same state (replicated, as the JAX package keeps them)."""
    return dataclasses.replace(state, **{
        name: all_gather_envs(getattr(state, name), mesh)
        for name in _ENV_LEAVES if getattr(state, name) is not None})


def shard_rows(rows, mesh: DataMesh):
    """This rank's envs (columns) of a global ``RowState``."""
    return type(rows)(*(shard(x, mesh, dim=-1) for x in rows.fields()))


def shard_buffer(buffer, mesh: DataMesh, num_agents: int):
    """This rank's envs of a global ``Buffer``: axis 1 of every leaf, the
    agents of an env kept together in the flattened (T, P*A) log-probs."""
    return type(buffer)(
        obs=shard(buffer.obs, mesh, 1), actions=shard(buffer.actions, mesh, 1),
        log_probs=shard(buffer.log_probs, mesh, 1, num_agents),
        values=shard(buffer.values, mesh, 1),
        returns=shard(buffer.returns, mesh, 1),
        done=shard(buffer.done, mesh, 1))


@torch.no_grad()
def check_replicated(modules, mesh: DataMesh) -> None:
    """Raise on every rank unless each rank holds rank 0's parameters of
    ``modules`` bit for bit (every rank builds them from the same seed; a
    difference would make the replicas drift apart)."""
    flat = torch.cat([p.detach().reshape(-1) for m in modules
                      for p in m.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    differs = torch.tensor([0 if torch.equal(flat, ref) else 1],
                           dtype=torch.int32, device=flat.device)
    all_reduce_sum(differs, mesh)
    if int(differs) != 0:
        raise RuntimeError(f"the networks differ between the ranks "
                           f"({int(differs)} of {mesh.world} differ from "
                           f"rank 0's)")
