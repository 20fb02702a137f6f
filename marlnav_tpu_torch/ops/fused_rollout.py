"""The whole random- or policy-mean rollout fused into one CUDA kernel.

Port of ``marlnav_tpu/ops/fused_rollout.py``, the bench kernel.  The kernel
(``ops/csrc/fused_rollout.cu``) steps each env through all T steps on a
group of ``ROLLOUT_LANES`` lanes of one warp (one an agent; past 8
obstacles ``ROLLOUT_RT_LANES``, chosen at launch by
``fused_collect.rt_lanes``), with the env state in registers —
observations, the actor as its (4, obs) affine
operator, the action (a Gaussian sample, or the policy mean with
``deterministic_actions``), dynamics, rewards and the auto-reset — and
writes only the (T, P) rewards and the final state: no training buffer and
no episode counters.  Its step is the collect kernel's
(``ops/csrc/env_step.cuh``), on the same Philox slots, so a sampled rollout
and a collect from the same seed, state and actor give the same rewards and
final state.

Unlike the TPU kernel, the port needs no ``P % 1024`` and no (8, 128)
tiling: rewards come out as (T, P) and injected ``noise`` is (T, n_draws,
P), as in the collect kernel.

Routing, with no fallback: CPU tensors run the plain version
``rollout_rows_reference`` (uniforms drawn from a generator seeded with
``seed``, as the collect's plain route draws them); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from marlnav_tpu_torch.config import TriangleInitConfig
# The row layout lives with the collect; re-exported here, where the JAX
# package defines it (marlnav_tpu/ops/fused_rollout.py).
from marlnav_tpu_torch.ops.fused_collect import (  # noqa: F401
    RowState,
    _affine_compose,
    _check_launch,
    _kernel_params,
    _KernelParams,
    _Rows,
    env_state_to_rows,
    launch_geometry,
    launch_shape,
    roll_rows,
    rows_to_env_arrays,
    rows_to_env_state,
)
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator, resolve_device


@torch.no_grad()
def rollout_rows_reference(sm: StepMath, rows: RowState, a_comp: torch.Tensor,
                           c_comp: torch.Tensor, uniforms: torch.Tensor,
                           deterministic: bool
                           ) -> Tuple[RowState, torch.Tensor]:
    """The rollout kernel's function in plain PyTorch: ``roll_rows`` on
    ``uniforms`` (T, n_draws, P), keeping the rewards.  Returns ``(final
    rows, rewards (T, P))``."""
    rewards = []
    final = roll_rows(sm, rows, a_comp, c_comp, uniforms, deterministic,
                      lambda s: rewards.append(s.reward))
    return final, torch.stack(rewards)


# Lanes of one warp that step one env together in the templated instances
# (kLanes in ops/csrc/fused_rollout.cu; the wrapper checks the library's),
# and the widths the run-time instance has (fused_rollout_rt_kernel<G,
# kMean>).
ROLLOUT_LANES = 4
ROLLOUT_RT_LANES = (4, 8, 16, 32)


def _library():
    from marlnav_tpu_torch.ops._build import load_library

    lib, _ = load_library("fused_rollout")
    # Every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and cuts the pointer.
    ptr = ctypes.c_void_p
    fn = lib.marlnav_fused_rollout
    fn.argtypes = [ptr] * 4 + [ctypes.c_uint32, ptr, ctypes.c_int, ptr] \
        + [ctypes.c_int] * 4 + [ptr]
    fn.restype = ctypes.c_int
    lib.marlnav_rollout_rt_smem.argtypes = [ctypes.c_int] * 4
    lib.marlnav_rollout_rt_smem.restype = ctypes.c_int
    for getter in (lib.marlnav_rollout_params_size,
                   lib.marlnav_rollout_max_obstacles,
                   lib.marlnav_rollout_lanes):
        getter.argtypes, getter.restype = [], ctypes.c_int
    if lib.marlnav_rollout_params_size() != ctypes.sizeof(_KernelParams):
        raise RuntimeError("StepParams layout differs between env_step.cuh "
                           "and _KernelParams")
    if lib.marlnav_rollout_lanes() != ROLLOUT_LANES:
        raise RuntimeError("kLanes of fused_rollout.cu differs from "
                           "ROLLOUT_LANES")
    if any(lib.marlnav_rollout_rt_smem(9, 0, 32, w) < 0
           for w in ROLLOUT_RT_LANES):
        raise RuntimeError("fused_rollout.cu lacks a run-time instance of "
                           "ROLLOUT_RT_LANES")
    return lib


def fused_rollout_rows(sm: StepMath, rows: RowState, a_comp: torch.Tensor,
                       c_comp: torch.Tensor, seed: int, num_steps: int,
                       deterministic: bool,
                       noise: Optional[torch.Tensor] = None,
                       lanes: Optional[int] = None
                       ) -> Tuple[RowState, torch.Tensor]:
    """Run ``num_steps`` rollout steps from ``rows``; returns ``(final rows,
    rewards (T, P))``.

    On CUDA tensors this launches the kernel (random numbers from its
    Philox stream keyed on ``seed``, or from ``noise`` (T, n_draws, P) when
    given) and raises on anything it cannot launch.  On CPU tensors it runs
    the plain version on ``noise``, or on uniforms drawn from a generator
    seeded with ``seed``.  ``lanes`` forces the run-time instance's lanes
    an env (one of ``ROLLOUT_RT_LANES``; ``launch_shape``), for tests and
    timings; the plain version ignores it.  ``fused_rollout_rows.launches``
    counts kernel launches."""
    device = rows.px.device
    num_envs = rows.px.shape[-1]
    if device.type == "cpu":
        if noise is None:
            noise = torch.rand((num_steps, sm.n_draws, num_envs),
                               generator=make_generator(seed, "cpu"))
        return rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                      deterministic)
    if device.type != "cuda":
        raise ValueError(f"fused rollout: unsupported device {device}")

    lib = _library()
    _check_launch(sm, rows, a_comp, c_comp, num_steps, noise)
    lanes, threads = launch_shape(
        "fused rollout", sm, num_envs, lib.marlnav_rollout_max_obstacles(),
        lib.marlnav_rollout_rt_smem, ROLLOUT_LANES, ROLLOUT_RT_LANES, lanes)
    weights = torch.cat([a_comp.reshape(-1), c_comp])
    out_rows = RowState(*(torch.empty_like(x) for x in rows.fields()))
    rewards = torch.empty((num_steps, num_envs), dtype=torch.float32,
                          device=device)
    blocks, threads = launch_geometry(num_envs, lanes, threads)
    err = lib.marlnav_fused_rollout(
        ctypes.byref(_Rows(*(x.data_ptr() for x in rows.fields()))),
        ctypes.byref(_Rows(*(x.data_ptr() for x in out_rows.fields()))),
        weights.data_ptr(), None if noise is None else noise.data_ptr(),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        ctypes.byref(_kernel_params(sm, num_envs, num_steps)),
        int(deterministic), rewards.data_ptr(), blocks, threads, lanes,
        device.index if device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused rollout kernel launch failed: CUDA error "
                           f"{err}")
    fused_rollout_rows.launches += 1
    return out_rows, rewards


fused_rollout_rows.launches = 0


def make_fused_rollout(env_params, init_cfg, normalizer_cfg, scaler_cfg,
                       num_steps: int, deterministic_actions: bool = False,
                       device="cuda"):
    """Build ``rollout(rows, actor, seed, noise=None) -> (rows', rewards
    (T, P))``, the counterpart of the JAX package's ``make_fused_rollout``
    on the RowState layout.  ``actor`` is an ``Actor``; ``seed`` an int
    (the kernel's Philox key); ``noise`` optionally injects the uniforms
    (T, n_draws, P).  ``deterministic_actions`` steps with the policy mean.

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``"cpu"`` for the plain version.  ``rows`` must lie on that device."""
    if not isinstance(init_cfg, TriangleInitConfig):
        raise NotImplementedError(
            "the fused rollout covers the triangle scenario family; mock "
            "scenarios step through env.step")
    dev = resolve_device(device)
    sm = StepMath(env_params, init_cfg, normalizer_cfg, scaler_cfg)

    def rollout(rows: RowState, actor, seed: int, noise=None):
        if rows.px.device.type != dev.type:
            raise ValueError(f"fused rollout built for {dev}, given rows on "
                             f"{rows.px.device}")
        a_comp, c_comp = _affine_compose(actor)
        return fused_rollout_rows(sm, rows, a_comp, c_comp, seed, num_steps,
                                  deterministic_actions, noise)

    return rollout
