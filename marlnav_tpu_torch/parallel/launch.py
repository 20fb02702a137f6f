"""Ranks on one host: spawn them, join them, fail with any of them.

The counterpart of one JAX process driving N local devices: the calling
process becomes rank 0 of a new process group and spawns ranks 1 .. N-1
(``torch.multiprocessing``, start method ``spawn``), which meet at a
``file://`` rendezvous in a temporary directory.
"""

from __future__ import annotations

import os
import tempfile

import torch.distributed as dist
import torch.multiprocessing as mp

from marlnav_tpu_torch.parallel.mesh import init_distributed


def _rank_process(target, rank: int, world: int, init_method: str,
                  backend: str, args) -> None:
    init_distributed(num_processes=world, process_id=rank, backend=backend,
                     init_method=init_method)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_local_ranks(world: int, backend: str, target, *args):
    """Run ``target(rank, world, *args)`` as every rank of a new process
    group of ``world`` ranks on this host; returns rank 0's result.

    This process is rank 0; ranks 1 .. world-1 are spawned processes, so
    ``target`` must be importable by name (not defined in a module run as
    ``__main__`` by ``python -m``).  Raises where any rank fails: rank 0's
    exception (the spawned ranks are then stopped, each after 10 s to
    finish on its own), or the exit codes of the spawned ranks that did
    not exit 0."""
    if world < 1:
        raise ValueError(f"need at least one rank, got {world}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="marlnav_rendezvous_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ranks = [ctx.Process(target=_rank_process, args=(
            target, rank, world, init_method, backend, args))
            for rank in range(1, world)]
        for proc in ranks:
            proc.start()
        try:
            init_distributed(num_processes=world, process_id=0,
                             backend=backend, init_method=init_method)
            try:
                result = target(0, world, *args)
            finally:
                dist.destroy_process_group()
        except BaseException:
            # A rank that failed first has its error to print: a grace
            # period, then the ranks still waiting are stopped.
            for proc in ranks:
                proc.join(timeout=10)
                proc.terminate()
            raise
        finally:
            for proc in ranks:
                proc.join()
    failed = {rank: proc.exitcode for rank, proc in enumerate(ranks, 1)
              if proc.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
    return result


def cli_training_rank(rank: int, world: int, cfg, args):
    """One rank of ``python -m marlnav_tpu_torch --num-data N [--num-model
    M]`` without ``--multihost``: rank r on ``cuda:r`` (or the CPU)."""
    from marlnav_tpu_torch.__main__ import train_rank

    return train_rank(cfg, args, rank, world)
