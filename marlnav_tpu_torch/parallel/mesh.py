"""Process groups and the data-parallel mesh.

Port of ``marlnav_tpu/parallel/mesh.py`` on ``torch.distributed``.  Where
the JAX package builds a ('data', 'model') mesh over the devices one
process drives, here each rank is a process with one device: the env batch
and the rollout buffer split over the ranks, the networks are replicated,
and the collectives (``parallel.sharding``) are NCCL's on the card, gloo's
on the CPU.  The 'model' axis (tensor parallelism) is not ported: any
``num_model`` other than 1 raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataMesh:
    """This rank's place in the data-parallel group (the default process
    group): its rank, the world size, its device and the group's backend.
    ``env_slice`` gives the rank's part of the env axis."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def env_slice(self, num_envs: int) -> Tuple[int, int]:
        """``(offset, count)`` of this rank's envs among ``num_envs``:
        equal shares, rank r's from ``r * count``.  Raises where
        ``num_envs`` does not split over the ranks."""
        if num_envs % self.world != 0:
            raise ValueError(f"num_envs {num_envs} does not split over "
                             f"{self.world} ranks")
        count = num_envs // self.world
        return self.rank * count, count


def default_backend(device) -> str:
    """NCCL for a mesh on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl",
                     init_method: Optional[str] = None) -> None:
    """Initialize the default process group (the counterpart of
    ``jax.distributed.initialize``, marlnav_tpu/__main__.py:163-172).

    With ``coordinator_address`` (host:port of rank 0) the ranks meet at
    ``tcp://<coordinator_address>``; without it at ``env://``, from
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them.  ``num_processes`` and ``process_id``, where
    given, take the place of ``WORLD_SIZE`` and ``RANK``.  ``init_method``
    (e.g. a ``file://`` rendezvous) overrides both."""
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}"
                       if coordinator_address is not None else "env://")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def _local(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device="cuda", local_rank: Optional[int] = None,
              local_world: Optional[int] = None) -> DataMesh:
    """The data-parallel mesh over the initialized default process group.

    ``num_data`` defaults to the group's size and must equal it (one
    process a rank).  ``device``: ``"cuda"`` gives rank r the card
    ``cuda:<local rank>`` (``local_rank``, else ``LOCAL_RANK``, else the
    rank) and raises unless this host has a card for each of its
    ``local_world`` ranks (else ``LOCAL_WORLD_SIZE``, else the world
    size: every rank on this host); ``"cuda:<k>"`` puts the rank on that
    card (several ranks on one card need gloo); ``"cpu"`` on the CPU.
    Raises ``ValueError`` as the JAX package's ``make_mesh`` does where the
    mesh needs more devices than there are, and ``NotImplementedError`` for
    ``num_model`` > 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_model
    use = num_data * num_model
    if use > world:
        raise ValueError(f"mesh {num_data}x{num_model} needs {use} "
                         f"devices, have {world}")
    if num_model != 1:
        raise NotImplementedError(
            "--num-model (tensor parallelism) is not ported to "
            "marlnav_tpu_torch yet (see ROADMAP.md); run python -m "
            "marlnav_tpu for it")
    if num_data != world:
        raise ValueError(f"--num-data {num_data} must equal the number of "
                         f"ranks, {world} (one process a rank)")
    backend = dist.get_backend()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh {num_data}x{num_model} on device {device!r} but CUDA "
                "is not available; pass --device cpu (device='cpu') to run "
                "on the CPU")
        have = torch.cuda.device_count()
        if dev.index is None:
            local_world = (_local("LOCAL_WORLD_SIZE", world)
                           if local_world is None else local_world)
            if local_world > have:
                raise ValueError(f"mesh {num_data}x{num_model} needs "
                                 f"{local_world} devices, have {have}")
            index = (_local("LOCAL_RANK", rank) if local_rank is None
                     else local_rank)
            dev = torch.device("cuda", index)
        elif dev.index >= have:
            raise ValueError(f"device {dev} does not exist: this host has "
                             f"{have} CUDA devices")
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError(f"the NCCL backend needs CUDA devices, not {dev}")
    return DataMesh(rank=rank, world=world, device=dev, backend=backend)
