"""Process groups and the (data x model) grid of ranks.

Port of ``marlnav_tpu/parallel/mesh.py`` on ``torch.distributed``.  Where
the JAX package reshapes the devices one process drives into a ('data',
'model') mesh, here each rank is a process with one device, and the ranks
form the same grid: rank r sits at data index ``r // num_model`` and model
index ``r % num_model`` (``np.asarray(devices).reshape(num_data,
num_model)``, marlnav_tpu/parallel/mesh.py:40).  The env batch and the
rollout buffer split over the data index; with ``num_model`` > 1 the
networks' hidden units split over the model index (``parallel.tensor``).
Each data column (the ranks of one model index) is a process group, the
data group, over which the data-parallel sums run; each data row (the
ranks of one data index) is another, the model group, over which the
tensor-parallel sums and gathers run.  At ``num_model`` 1 the data group
is the default group and there is no model group.  The collectives
(``parallel.sharding``) are NCCL's on the card, gloo's on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data x model) grid: its rank and the world
    size (of the default process group), its device, the groups' backend,
    the grid's shape and its two groups (``data_group`` None: the default
    group; ``model_group`` None: no tensor parallelism).  ``env_slice``
    gives the rank's part of the env axis."""

    rank: int
    world: int
    device: torch.device
    backend: str
    num_data: int
    num_model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    def env_slice(self, num_envs: int) -> Tuple[int, int]:
        """``(offset, count)`` of this rank's envs among ``num_envs``:
        equal shares over the data index, data index d's from ``d *
        count`` (every rank of a model group holds the same envs).  Raises
        where ``num_envs`` does not split over the data size."""
        if num_envs % self.num_data != 0:
            raise ValueError(f"num_envs {num_envs} does not split over "
                             f"{self.num_data} ranks")
        count = num_envs // self.num_data
        return self.data_index * count, count


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
              local_world: Optional[int] = None) -> Mesh:
    """The (data x model) grid over the initialized default process group.

    ``num_data`` defaults to the group's size // ``num_model``, and
    ``num_data * num_model`` must equal the group's size (one process a
    rank).  With ``num_model`` > 1 every rank creates the process group of
    each data column and of each data row, in one fixed order (columns,
    then rows), as ``dist.new_group`` needs every rank to.  ``device``:
    ``"cuda"`` gives rank r the card ``cuda:<local rank>`` (``local_rank``,
    else ``LOCAL_RANK``, else the rank) and raises unless this host has a
    card for each of its ``local_world`` ranks (else
    ``LOCAL_WORLD_SIZE``, else the world size: every rank on this host);
    ``"cuda:<k>"`` puts the rank on that card (several ranks on one card
    need gloo); ``"cpu"`` on the CPU.
    Raises ``ValueError`` as the JAX package's ``make_mesh`` does where the
    mesh needs more devices than there are."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_model < 1:
        raise ValueError(f"--num-model must be >= 1, got {num_model}")
    if num_data is None:
        num_data = world // num_model
    use = num_data * num_model
    if use > world:
        raise ValueError(f"mesh {num_data}x{num_model} needs {use} "
                         f"devices, have {world}")
    if use != world:
        model = f" x --num-model {num_model}" if num_model != 1 else ""
        raise ValueError(f"--num-data {num_data}{model} must equal the "
                         f"number of ranks, {world} (one process a rank)")
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
    data_group = model_group = None
    if num_model > 1:
        columns = [dist.new_group([d * num_model + m
                                   for d in range(num_data)])
                   for m in range(num_model)]
        rows = [dist.new_group(list(range(d * num_model,
                                          (d + 1) * num_model)))
                for d in range(num_data)]
        data_group = columns[rank % num_model]
        model_group = rows[rank // num_model]
    return Mesh(rank=rank, world=world, device=dev, backend=backend,
                num_data=num_data, num_model=num_model,
                data_group=data_group, model_group=model_group)
