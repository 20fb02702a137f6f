"""Actor and centralized-critic MLPs as ``nn.Module``s.

Port of ``marlnav_tpu/models/networks.py``; the architectures replicate the
reference (reference models.py:14-56), including the actor's *missing*
hidden activation (reference models.py:29):

  Actor : (..., A, obs) -> flatten agents into batch -> Linear(obs, H)
          -> heads tanh(Linear(H, 2)) = mean, softplus(Linear(H, 2)) = var
  Critic: (..., A, obs) -> flatten agents into features (CTDE) ->
          Linear(A*obs, H) -> ReLU -> Linear(H, 1)

Initialization: orthogonal weights (reference models.py:21-25, 46-49) and
uniform(-1/sqrt(fan_in), +1/sqrt(fan_in)) biases, drawn from an explicit
generator.

Tensor parallelism (``--num-model``; marlnav_tpu/parallel/sharding.py:
64-94): a network whose ``model_group`` is set holds only its rank's
hidden units (``parallel.tensor.shard_network``).  Its ``fc1`` is
column-parallel, a local ``F.linear`` on those units with no collective;
its heads are row-parallel, each the local partial ``h_m W_mᵀ``, summed
over the model group by one all-reduce for all heads together (the
actor's (N, 4) partial of both heads), then the replicated bias.  The
all-reduce is ``_SumOverGroup``, whose gradient passes through unchanged:
every rank of the group computes the same loss from the summed output, so
each holds the whole output gradient, and its local weight gradients are
the shards of the whole ones.  The JAX package's other collective, the
all-reduce of ``fc1``'s input gradient, never fires here: the
observations take no gradient.  ``compute_dtype`` rounds each operand as
``_linear`` does, the partials are float32 sums of the rounded products,
and they are summed over the group in float32.  Without a
``model_group`` the networks run as above, unsharded.

Weights interchange with the JAX package: the JAX ``Dense`` stores ``w`` as
(in, out) and ``nn.Linear.weight`` is (out, in).  ``from_jax_params`` and
``to_jax_params`` convert; ``flat_params`` / ``load_flat_params`` use the
``.npz`` key format of ``marlnav_tpu/utils/stats.py`` ("fc1.w", "fc1.b",
...), so weight files written by either package load in the other.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F


def _orthogonal(out_size: int, in_size: int,
                generator: torch.Generator) -> torch.Tensor:
    """(out, in) matrix with orthonormal rows or columns (whichever is the
    smaller set) — the orthogonal initializer of torch and of JAX."""
    rows, cols = (out_size, in_size) if out_size >= in_size else (
        in_size, out_size)
    a = torch.randn((rows, cols), generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if out_size >= in_size else q.T


def _dense(in_size: int, out_size: int, generator: torch.Generator):
    layer = nn.Linear(in_size, out_size)
    bound = 1.0 / math.sqrt(in_size)
    with torch.no_grad():
        layer.weight.copy_(_orthogonal(out_size, in_size, generator))
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and back (itself for None)."""
    return x if compute_dtype is None else x.to(compute_dtype).to(x.dtype)


def _linear(x, layer: nn.Linear, compute_dtype):
    """``layer(x)``; with ``compute_dtype``, both operands of the product
    rounded to it, the products summed in float32 and the float32 bias
    added: the JAX package's ``Dense.cast(compute_dtype)``.  Each call
    rounds its own copy of ``x``, so the backward rounds each use's
    gradient to ``compute_dtype`` once and sums the uses in float32, as
    JAX's transposed bf16 operands do on the CPU (the sum of a hidden
    activation's two uses is not rounded)."""
    return F.linear(_rounded(x, compute_dtype),
                    _rounded(layer.weight, compute_dtype), layer.bias)


class _SumOverGroup(torch.autograd.Function):
    """``x`` summed over a process group (an all-reduce in the forward);
    the gradient passes through unchanged, the same on every rank of the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _row_parallel(h, heads, compute_dtype, group):
    """Each head ``layer(h)`` of a row-parallel split: this rank's partial
    products of every head in one (N, sum of outputs) tensor, summed over
    ``group`` by one all-reduce, then each head's bias."""
    partial = torch.cat([F.linear(_rounded(h, compute_dtype),
                                  _rounded(layer.weight, compute_dtype))
                         for layer in heads], -1)
    total = _SumOverGroup.apply(partial, group)
    out, start = [], 0
    for layer in heads:
        n = layer.weight.shape[0]
        out.append(total[:, start:start + n] + layer.bias)
        start += n
    return out


class Actor(nn.Module):
    """obs (..., A, obs_size) -> (mean, var), each (...*A, action_size);
    ``var`` is the covariance diagonal (see distributions.py).

    ``compute_dtype=torch.bfloat16`` (``--bf16-updates``) runs as the JAX
    package's ``actor_apply(..., compute_dtype)``: the products' operands
    rounded to bf16, the products summed in float32 (TF32 stays off), the
    bias float32, the hidden activations rounded to bf16.  ``model_group``:
    see the module docstring."""

    model_group: Optional[dist.ProcessGroup] = None

    def __init__(self, obs_size: int, hidden_size: int, action_size: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.fc1 = _dense(obs_size, hidden_size, g)
        self.fc_mu = _dense(hidden_size, action_size, g)
        self.fc_var = _dense(hidden_size, action_size, g)

    def forward(self, obs: torch.Tensor, compute_dtype=None):
        x = obs.reshape(-1, obs.shape[-1])
        # NB: no activation (reference models.py:29)
        h = _linear(x, self.fc1, compute_dtype)
        if self.model_group is not None:
            mu, var = _row_parallel(h, (self.fc_mu, self.fc_var),
                                    compute_dtype, self.model_group)
            return torch.tanh(mu), F.softplus(var)
        return (torch.tanh(_linear(h, self.fc_mu, compute_dtype)),
                F.softplus(_linear(h, self.fc_var, compute_dtype)))


class Critic(nn.Module):
    """obs (N, A, obs_size) -> values (N, 1): agents fold into the feature
    axis — the centralized critic (reference models.py:44, 51-55).
    ``compute_dtype`` and ``model_group`` as in ``Actor``."""

    model_group: Optional[dist.ProcessGroup] = None

    def __init__(self, obs_size: int, num_agents: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.fc1 = _dense(obs_size * num_agents, hidden_size, g)
        self.fc2 = _dense(hidden_size, 1, g)

    def forward(self, obs: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1)
        h = torch.relu(_linear(x, self.fc1, compute_dtype))
        if self.model_group is not None:
            return _row_parallel(h, (self.fc2,), compute_dtype,
                                 self.model_group)[0]
        return _linear(h, self.fc2, compute_dtype)


def with_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor],
                 model_group=None) -> nn.Module:
    """A network of ``module``'s class whose parameters are ``tensors``
    (keyed as ``module.named_parameters()``, held as they are: no copy, no
    initialization), with ``model_group``."""
    out = type(module).__new__(type(module))
    nn.Module.__init__(out)
    for name in _layers(module):
        layer = nn.Linear.__new__(nn.Linear)
        nn.Module.__init__(layer)
        layer.weight = nn.Parameter(tensors[f"{name}.weight"],
                                    requires_grad=False)
        layer.bias = nn.Parameter(tensors[f"{name}.bias"],
                                  requires_grad=False)
        layer.out_features, layer.in_features = layer.weight.shape
        setattr(out, name, layer)
    out.model_group = model_group
    return out


def _layers(module: nn.Module) -> Dict[str, nn.Linear]:
    return {name: m for name, m in module.named_children()
            if isinstance(m, nn.Linear)}


# ----------------------------------------------------------------------
# Weight interchange with the JAX package
# ----------------------------------------------------------------------


def flat_params(module: nn.Module) -> Dict[str, np.ndarray]:
    """{"fc1.w": (in, out), "fc1.b": (out,), ...} float32 numpy arrays —
    the JAX package's ``.npz`` weight-file keys and layout."""
    out = {}
    for name, layer in _layers(module).items():
        out[f"{name}.w"] = layer.weight.detach().cpu().numpy().T.copy()
        out[f"{name}.b"] = layer.bias.detach().cpu().numpy().copy()
    return out


def load_flat_params(module: nn.Module, flat) -> nn.Module:
    """Inverse of ``flat_params``: copy ``flat`` (a mapping in the ``.npz``
    key format) into ``module`` in place, checking every shape."""
    with torch.no_grad():
        for name, layer in _layers(module).items():
            for key, param, to_torch in (
                    (f"{name}.w", layer.weight, np.transpose),
                    (f"{name}.b", layer.bias, np.asarray)):
                arr = np.asarray(flat[key])
                want = tuple(to_torch(np.empty(param.shape)).shape)
                if arr.shape != want:
                    raise ValueError(
                        f"weight {key}: file shape {arr.shape} != model {want}")
                param.copy_(torch.tensor(to_torch(arr), dtype=torch.float32))
    return module


def _tree_to_flat(tree) -> Dict[str, np.ndarray]:
    """A JAX ``ActorParams``/``CriticParams`` (or the same nesting as dicts)
    holding numpy arrays -> the flat ``.npz`` key format."""
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    flat = {}
    for name, dense in items:
        get = dense.get if isinstance(dense, dict) else (
            lambda k, d=dense: getattr(d, k))
        flat[f"{name}.w"] = np.asarray(get("w"))
        flat[f"{name}.b"] = np.asarray(get("b"))
    return flat


def from_jax_params(np_tree):
    """``(actor_params, critic_params)`` of the JAX package, as numpy arrays
    -> ``(Actor, Critic)`` with the same weights."""
    actor_tree, critic_tree = np_tree
    af, cf = _tree_to_flat(actor_tree), _tree_to_flat(critic_tree)
    obs_size, hidden = af["fc1.w"].shape
    actor = Actor(obs_size, hidden, af["fc_mu.w"].shape[1])
    critic = Critic(obs_size, cf["fc1.w"].shape[0] // obs_size, hidden)
    return load_flat_params(actor, af), load_flat_params(critic, cf)


def to_jax_params(actor: Actor, critic: Critic):
    """Inverse of ``from_jax_params``: nested dicts
    ``{"fc1": {"w": (in, out), "b": (out,)}, ...}`` of numpy arrays, one
    per network, in the JAX package's ``Dense`` layout."""
    def nest(flat):
        out = {}
        for key, arr in flat.items():
            layer, leaf = key.split(".")
            out.setdefault(layer, {})[leaf] = arr
        return out

    return nest(flat_params(actor)), nest(flat_params(critic))
