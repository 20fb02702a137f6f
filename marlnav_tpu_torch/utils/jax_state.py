"""Read the JAX programs' state pickles without the JAX package.

``scripts/curriculum.py --save-state`` pickles a dict of numpy trees:
``ts`` (the JAX package's ``TrainState``: ``ActorParams`` /
``CriticParams`` of ``Dense`` layers, each optimizer an optax chain state
``(ScaleByAdamState(count, mu, nu), EmptyState())``), ``rows`` (its
``RowState``), and the schedule scalars ``radius``, ``ent``, ``gr`` and,
from its fifth round on, ``stage`` and ``share``.  ``Dense.w`` is stored
``(in, out)``; the rows are ``(A or O or 2, P)``.

The loader here is a restricted ``pickle.Unpickler``: the seven class
names above resolve to this module's own ``NamedTuple`` stand-ins (same
field names), numpy's array reconstructors to numpy, and any other global
raises ``pickle.UnpicklingError`` naming it.  The files are data; nothing
in them is imported or called beyond those.  numpy 2 pickles its
reconstructors under ``numpy._core``; under numpy 1 they are read from
``numpy.core``.

``load_jax_state`` turns such a file into the port's objects: the networks
through ``models.networks.from_jax_params`` (``(in, out)`` -> ``(out,
in)``), the rows into ``ops.fused_collect.RowState``, and optax's Adam
into the port's ``algo.mappo.make_adam`` optimizers: ``mu`` ->
``exp_avg``, ``nu`` -> ``exp_avg_sq`` (transposed alike), ``count`` ->
``step``.  optax's and torch's Adam take the same defaults (betas 0.9 /
0.999, eps 1e-8) and the same bias-corrected update, so a step from the
converted state is optax's step.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch


class Dense(NamedTuple):
    w: np.ndarray  # (in, out)
    b: np.ndarray  # (out,)


class ActorParams(NamedTuple):
    fc1: Dense
    fc_mu: Dense
    fc_var: Dense


class CriticParams(NamedTuple):
    fc1: Dense
    fc2: Dense


class TrainState(NamedTuple):
    actor: ActorParams
    critic: CriticParams
    actor_opt: tuple  # (ScaleByAdamState, EmptyState)
    critic_opt: tuple


class ScaleByAdamState(NamedTuple):
    count: np.ndarray  # () int32: steps taken
    mu: object  # first moments, the parameters' tree
    nu: object  # second moments


class EmptyState(NamedTuple):
    pass


class RowState(NamedTuple):
    px: np.ndarray
    py: np.ndarray
    dx: np.ndarray
    dy: np.ndarray
    sp: np.ndarray
    obx: np.ndarray
    oby: np.ndarray
    tg: np.ndarray
    misc: np.ndarray


_CLASSES = {
    ("marlnav_tpu.algo.mappo", "TrainState"): TrainState,
    ("marlnav_tpu.models.networks", "ActorParams"): ActorParams,
    ("marlnav_tpu.models.networks", "CriticParams"): CriticParams,
    ("marlnav_tpu.models.networks", "Dense"): Dense,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("marlnav_tpu.ops.fused_rollout", "RowState"): RowState,
}
# numpy's array and scalar reconstructors, by numpy 1's module names.
_NUMPY = {("numpy.core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy", "ndarray"), ("numpy", "dtype")}

SCHEDULE_KEYS = ("radius", "ent", "gr", "stage", "share")


def numpy_module(module: str, name: str, numpy_major: int):
    """The module to resolve numpy's global ``module.name`` from under
    numpy ``numpy_major`` (``numpy._core`` read as ``numpy.core`` under
    numpy 1), or None where it is not one of the allowed reconstructors."""
    canonical = module.replace("numpy._core", "numpy.core", 1) \
        if module.startswith("numpy._core") else module
    if (canonical, name) not in _NUMPY:
        return None
    return canonical if numpy_major < 2 else module


class _Unpickler(pickle.Unpickler):
    """Resolves only the JAX state's classes (to the stand-ins above) and
    numpy's reconstructors."""

    def find_class(self, module, name):
        if (module, name) in _CLASSES:
            return _CLASSES[(module, name)]
        resolved = numpy_module(module, name,
                                int(np.__version__.split(".")[0]))
        if resolved is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a JAX curriculum state "
                f"file")
        return super().find_class(resolved, name)


def read_jax_pickle(path: str) -> dict:
    """The state file at ``path`` as a dict of this module's stand-ins and
    numpy arrays (``ts``, ``rows``) and the schedule scalars."""
    with open(path, "rb") as fh:
        snap = _Unpickler(fh).load()
    if not isinstance(snap, dict) or "ts" not in snap or "rows" not in snap:
        raise pickle.UnpicklingError(f"{path}: not a curriculum state (a "
                                     f"dict with 'ts' and 'rows')")
    return snap


def _adam_state(opt: torch.optim.Optimizer, module: torch.nn.Module,
                adam: ScaleByAdamState) -> dict:
    """``adam``'s moments and count as a ``state_dict`` of ``opt`` (Adam
    over ``module``'s parameters, ``nn.Linear`` layers named as the JAX
    tree's fields)."""
    from marlnav_tpu_torch.models.networks import _layers

    step = float(np.asarray(adam.count))
    state = {}
    index = {id(p): i for i, p in enumerate(
        q for group in opt.param_groups for q in group["params"])}
    for name, layer in _layers(module).items():
        mu, nu = getattr(adam.mu, name), getattr(adam.nu, name)
        for param, leaf, to_torch in ((layer.weight, "w", np.transpose),
                                      (layer.bias, "b", np.asarray)):
            m = to_torch(np.asarray(getattr(mu, leaf), np.float32))
            v = to_torch(np.asarray(getattr(nu, leaf), np.float32))
            if m.shape != tuple(param.shape) or v.shape != m.shape:
                raise ValueError(f"Adam moments of {name}.{leaf}: "
                                 f"{m.shape} / {v.shape}, parameter "
                                 f"{tuple(param.shape)}")
            # In the parameter's own layout: the fused Adam takes no other.
            state[index[id(param)]] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.empty_like(param).copy_(
                    torch.from_numpy(m)),
                "exp_avg_sq": torch.empty_like(param).copy_(
                    torch.from_numpy(v))}
    return {"state": state, "param_groups": opt.state_dict()["param_groups"]}


def load_jax_state(path: str, device="cuda", lr: float = 3e-4):
    """``(TrainState, RowState, schedule)`` of the JAX state file at
    ``path``: the port's ``algo.mappo.TrainState`` (networks and Adam
    optimizers at ``lr`` on ``device``, as ``make_adam`` builds them
    there), the port's ``ops.fused_collect.RowState`` on ``device``, and
    the dict of the schedule scalars the file holds (``SCHEDULE_KEYS``).
    ``device`` defaults to CUDA and raises when CUDA is absent."""
    from marlnav_tpu_torch.algo.mappo import TrainState as PortTrainState
    from marlnav_tpu_torch.algo.mappo import make_adam
    from marlnav_tpu_torch.models import from_jax_params
    from marlnav_tpu_torch.ops.fused_collect import RowState as PortRows
    from marlnav_tpu_torch.train import restore_adam
    from marlnav_tpu_torch.utils.seeding import resolve_device

    dev = resolve_device(device)
    snap = read_jax_pickle(path)
    ts = snap["ts"]
    actor, critic = (m.to(dev) for m in from_jax_params((ts.actor,
                                                         ts.critic)))
    opts = []
    for module, chain in ((actor, ts.actor_opt), (critic, ts.critic_opt)):
        adam = chain[0]
        if not isinstance(adam, ScaleByAdamState) or any(
                not isinstance(s, EmptyState) for s in chain[1:]):
            raise ValueError(f"{path}: optimizer state {type(chain)} is not "
                             f"optax.adam's chain")
        opt = make_adam(module, lr)
        restore_adam(opt, _adam_state(opt, module, adam))
        opts.append(opt)
    rows = PortRows(*(torch.tensor(np.asarray(x, np.float32), device=dev)
                      for x in snap["rows"]))
    schedule = {k: snap[k] for k in SCHEDULE_KEYS if k in snap}
    return PortTrainState(actor, critic, *opts), rows, schedule
