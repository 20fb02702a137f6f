"""The inputs a run hands the program, made from ``--seed``: the port's
config objects from a configuration file, the initial weights and the
initial env rows, drawn on the device by one ``torch.Generator`` in a few
large calls."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

# Fields the harness sets from the traffic, not from the configuration.
_LOAD_FIELDS = {"num_parallel", "num_total"}


def _port_object(cls, section: dict, **load):
    """``cls`` (one of the port's config dataclasses) from a configuration
    section; raises where the section lacks a field, so that every value
    the program runs with is in the benchmark's file."""
    names = {f.name for f in dataclasses.fields(cls)} - set(load)
    missing = sorted(n for n in names - set(section) if n not in _LOAD_FIELDS)
    if missing:
        raise ValueError(f"{cls.__name__}: the configuration lacks "
                         f"{missing}")
    return cls(**{k: v for k, v in section.items() if k in names}, **load)


def port_configs(config: dict, envs: int, overrides: dict = None):
    """``(EnvParams, TriangleInitConfig, NormalizerConfig, ScalerConfig,
    MAPPOConfig)`` of ``config`` at ``envs`` envs; ``overrides`` replace
    model fields (the control's ``bf16_updates``, a test's sizes)."""
    from marlnav_tpu_torch.config import (EnvParams, MAPPOConfig,
                                          NormalizerConfig, ScalerConfig,
                                          TriangleInitConfig)

    env = _port_object(EnvParams, config["env"], num_parallel=envs)
    init = _port_object(TriangleInitConfig, config["init"],
                        num_parallel=envs)
    norm = _port_object(NormalizerConfig, config["normalizer"])
    scal = _port_object(ScalerConfig, config["scaler"])
    model = dict(config["model"], **(overrides or {}))
    mcfg = _port_object(MAPPOConfig, model, num_parallel=envs,
                        num_total=envs * model["buffer_len"])
    return env, init, norm, scal, mcfg


def network_shapes(config: dict, overrides: dict = None):
    """``{"actor": {name: shape}, "critic": {name: shape}}``."""
    m = dict(config["model"], **(overrides or {}))
    f, h, a = m["obs_size"], m["hidden_size"], m["num_agents"]
    act = m["action_size"]
    return {"actor": {"fc1.weight": (h, f), "fc1.bias": (h,),
                      "fc_mu.weight": (act, h), "fc_mu.bias": (act,),
                      "fc_var.weight": (act, h), "fc_var.bias": (act,)},
            "critic": {"fc1.weight": (h, a * f), "fc1.bias": (h,),
                       "fc2.weight": (1, h), "fc2.bias": (1,)}}


def initial_weights(generator: torch.Generator, shapes: Dict[str, dict],
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every layer's weight and bias uniform in +-1/sqrt(fan in), as
    ``nn.Linear`` draws them, from one draw of the generator."""
    flat = [(net, name, shape) for net in shapes
            for name, shape in shapes[net].items()]
    total = sum(math.prod(s) for _, _, s in flat)
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    out, start = {net: {} for net in shapes}, 0
    for net, name, shape in flat:
        n = math.prod(shape)
        layer = name.split(".")[0]
        fan_in = shapes[net][f"{layer}.weight"][1]
        out[net][name] = (u[start:start + n] / math.sqrt(fan_in)
                          ).reshape(shape)
        start += n
    return out


def initial_rows(generator: torch.Generator, config: dict, envs: int,
                 device) -> Dict[str, torch.Tensor]:
    """The triangle scenario's initial state in the kernels' row layout:
    the agents on the triangle facing +x at the initial speed, the
    obstacles uniform in their box, the target disk, step counters at 0
    (spread uniformly over an episode with staggered resets)."""
    env, init = config["env"], config["init"]
    a, o = env["num_agents"], env["num_obstacles"]
    f32 = dict(dtype=torch.float32, device=device)
    half, r3 = 0.5 * init["ags_dist"], math.sqrt(3.0)
    bx = [init["ags_cent_x"] + half * v for v in (-1 / r3, 2 / r3, -1 / r3)]
    by = [init["ags_cent_y"] + half * v for v in (1.0, 0.0, -1.0)]
    u = torch.rand((2, o, envs), generator=generator, **f32) - 0.5
    ox = 0.5 * (init["obst_min_x"] + init["obst_max_x"])
    oy = 0.5 * (init["obst_min_y"] + init["obst_max_y"])
    steps = torch.zeros(envs, **f32)
    if env["staggered_resets"]:
        steps = torch.randint(0, env["episode_len"], (envs,),
                              generator=generator, device=device).float()
    ones = torch.ones((a, envs), **f32)
    return {
        "px": torch.tensor(bx, **f32)[:, None] * ones,
        "py": torch.tensor(by, **f32)[:, None] * ones,
        "dx": ones.clone(), "dy": torch.zeros((a, envs), **f32),
        "sp": ones * init["init_speed"],
        "obx": u[0] * (init["obst_max_x"] - init["obst_min_x"]) + ox,
        "oby": u[1] * (init["obst_max_y"] - init["obst_min_y"]) + oy,
        "tg": torch.tensor([[init["tar_pos_x"]], [init["tar_pos_y"]]], **f32)
        * torch.ones((1, envs), **f32),
        "misc": torch.stack([steps, torch.zeros(envs, **f32)])}


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> None:
    """Copy ``weights`` into ``module``'s parameters (names as
    ``named_parameters``)."""
    with torch.no_grad():
        params = dict(module.named_parameters())
        if set(params) != set(weights):
            raise ValueError(f"weights {sorted(weights)} do not match the "
                             f"network's {sorted(params)}")
        for name, w in weights.items():
            params[name].copy_(w)
