"""Tensor parallelism: each network's hidden units split over the model
group.

Port of ``train_state_shardings``, ``shard_train_state`` and
``_put_opt_like`` with ``tensor_parallel=True``
(marlnav_tpu/parallel/sharding.py:64-130).  Model index m of M holds
hidden units ``[m H/M, (m + 1) H/M)``: its rows of ``fc1.weight`` and
``fc1.bias`` (column-parallel) and its columns of each head's ``weight``
(row-parallel); the heads' biases are replicated.  Adam's ``exp_avg`` and
``exp_avg_sq`` follow their parameter, since Adam runs on the shards.
Every rank builds the whole networks from the run seed and keeps its
slice (``shard_network``), so a tensor-parallel run starts from an
unsharded run's weights, as in the JAX package.  The forward of a split
network is ``models/networks.py``'s.

The ``gather_*`` functions rebuild whole tensors over the model group, in
column order, with one all-gather of a flat buffer: the kernel routes
take whole weights (as the JAX package's ``shard_map`` phases take them
replicated, marlnav_tpu/algo/mappo.py:473-483), and checkpoints and
weight files hold whole networks.  A network without a ``model_group``
passes through every function here unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from marlnav_tpu_torch.models.networks import with_tensors


def split_dim(name: str) -> Optional[int]:
    """The axis of parameter ``name`` (a key of ``named_parameters()``)
    that holds hidden units: 0 for ``fc1``'s weight and bias
    (column-parallel), 1 for a head's weight (row-parallel), None for a
    head's bias (replicated)."""
    layer, leaf = name.rsplit(".", 1)
    if layer == "fc1":
        return 0
    return 1 if leaf == "weight" else None


def check_split(hidden_size: int, num_model: int) -> None:
    """Raise ``ValueError`` unless ``hidden_size`` splits over
    ``num_model`` model indices (the JAX package's ``device_put`` refuses
    such a sharding)."""
    if hidden_size % num_model != 0:
        raise ValueError(f"hidden size {hidden_size} does not split over "
                         f"--num-model {num_model}: the hidden units shard "
                         f"over the model axis")


def shard_tensor(name: str, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` of parameter ``name``
    (or of its gradient or Adam moment), contiguous; ``x`` itself where
    nothing splits."""
    dim = split_dim(name)
    if mesh is None or mesh.num_model == 1 or dim is None:
        return x
    check_split(x.shape[dim], mesh.num_model)
    n = x.shape[dim] // mesh.num_model
    return x.narrow(dim, mesh.model_index * n, n).contiguous()


@torch.no_grad()
def shard_network(module: nn.Module, mesh) -> nn.Module:
    """Keep this rank's hidden units of the whole network ``module``, in
    place (new parameters: build its optimizer after this), and set its
    ``model_group``; nothing changes without tensor parallelism."""
    if mesh is None or mesh.num_model == 1:
        return module
    check_split(module.fc1.weight.shape[0], mesh.num_model)
    for name, layer in module.named_children():
        for leaf in ("weight", "bias"):
            whole = getattr(layer, leaf).detach()
            setattr(layer, leaf, nn.Parameter(
                shard_tensor(f"{name}.{leaf}", whole, mesh).clone()))
        layer.out_features, layer.in_features = layer.weight.shape
    module.model_group = mesh.model_group
    return module


def _gather(pieces: Sequence[Tuple[torch.Tensor, Optional[int]]],
            group) -> List[torch.Tensor]:
    """Each local ``(tensor, dim)`` whole over ``group``: the model
    indices' tensors concatenated along ``dim`` in column order, or the
    tensor itself for ``dim`` None; one all-gather for all of them."""
    split = [x for x, dim in pieces if dim is not None]
    if not split:
        return [x for x, _ in pieces]
    flat = torch.cat([x.reshape(-1) for x in split])
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    out, start = [], 0
    for x, dim in pieces:
        if dim is None:
            out.append(x)
            continue
        n = x.numel()
        out.append(torch.cat([p[start:start + n].view_as(x) for p in parts],
                             dim))
        start += n
    return out


@torch.no_grad()
def gather_networks(modules: Sequence[nn.Module]) -> List[nn.Module]:
    """Whole copies of tensor-parallel networks, gathered over their model
    group in one all-gather (every rank of the group calls it); a network
    without a ``model_group`` is returned itself."""
    split = [m for m in modules
             if getattr(m, "model_group", None) is not None]
    if not split:
        return list(modules)
    named = [(m, k, p.detach()) for m in split
             for k, p in m.named_parameters()]
    whole = _gather([(p, split_dim(k)) for _, k, p in named],
                    split[0].model_group)
    tensors = {id(m): {} for m in split}
    for (m, k, _), x in zip(named, whole):
        tensors[id(m)][k] = x
    return [with_tensors(m, tensors[id(m)]) if id(m) in tensors else m
            for m in modules]


@torch.no_grad()
def whole_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors (a collective over its
    model group)."""
    named = {k: v.detach() for k, v in module.state_dict().items()}
    if module.model_group is None:
        return named
    return dict(zip(named, _gather([(x, split_dim(k)) for k, x in
                                    named.items()], module.model_group)))


def _adam_moments(module: nn.Module, state: dict):
    """((index, moment key), parameter name) of every tensor moment of an
    Adam ``state_dict`` over ``module``'s parameters, in order."""
    names = [k for k, _ in module.named_parameters()]
    return [((i, key), names[i]) for i in sorted(state["state"])
            for key in ("exp_avg", "exp_avg_sq")
            if key in state["state"][i]]


def _with_moments(state: dict, moments) -> dict:
    """A copy of the Adam ``state`` dict with its moments replaced."""
    out = {"state": {i: dict(s) for i, s in state["state"].items()},
           "param_groups": state["param_groups"]}
    for (i, key), x in moments.items():
        out["state"][i][key] = x
    return out


@torch.no_grad()
def whole_adam_state(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``opt.state_dict()`` (Adam over ``module``'s parameters) with each
    moment whole, as its parameter (a collective over the model group)."""
    state = opt.state_dict()
    if module.model_group is None:
        return state
    moments = _adam_moments(module, state)
    whole = _gather([(state["state"][i][key], split_dim(name))
                     for (i, key), name in moments], module.model_group)
    return _with_moments(state, dict(zip([m for m, _ in moments], whole)))


def shard_state_dict(state: Dict[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole network ``state`` dict."""
    return {k: shard_tensor(k, v, mesh) for k, v in state.items()}


def shard_adam_state(state: dict, module: nn.Module, mesh) -> dict:
    """This rank's slices of a whole Adam ``state`` dict over ``module``'s
    parameters."""
    if mesh is None or mesh.num_model == 1:
        return state
    return _with_moments(state, {
        (i, key): shard_tensor(name, state["state"][i][key], mesh)
        for (i, key), name in _adam_moments(module, state)})
