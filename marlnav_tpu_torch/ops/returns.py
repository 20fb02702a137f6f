"""The reverse recursions of the returns through one CUDA kernel.

Replaces ``marlnav_tpu/algo/mappo.py:96 discounted_returns`` and ``:134
gae_advantages`` (XLA scans in the JAX package, not Pallas kernels).  The
recursions run backwards over the T steps and independently for each env
column, so the kernel (``ops/csrc/returns.cu``) gives each column one
thread.  It performs the plain loops' float operations in their order
(``-fmad=false``), so it equals them bit for bit.  The JAX package's fused
path runs the associative forms of the recursions; the port keeps the
sequential order everywhere (the JAX package's reference order; the two
differ by reassociation only).

Accumulation in float32, or float64 for ``--returns-f64``: the float64
instances read the float32 rewards and values, accumulate in double and
return double (marlnav_tpu/algo/mappo.py:122-131).

Routing, with no fallback: CPU tensors run the plain loops
(``discounted_returns_reference``, ``gae_advantages_reference``); CUDA
tensors launch the kernel or raise.  ``returns_scan.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_DTYPES = (torch.float32, torch.float64)


def discounted_returns_reference(rewards: torch.Tensor, done: torch.Tensor,
                                 gamma: float,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Reverse-loop zero-at-done discounted returns (reference
    models.py:131-148), accumulated in ``dtype``.  rewards/done (T, P) ->
    returns (T, P)."""
    rewards = rewards.to(dtype)
    rets = torch.empty_like(rewards)
    curr = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        curr = torch.where(done[t], 0.0, rewards[t] + gamma * curr)
        rets[t] = curr
    return rets


def gae_advantages_reference(rewards: torch.Tensor, done: torch.Tensor,
                             values: torch.Tensor, last_value: torch.Tensor,
                             gamma: float, lam: float,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Bootstrapped GAE(lambda), accumulated in ``dtype``.
    rewards/done/values (T, P), last_value (P,) -> advantages (T, P)."""
    rewards, values = rewards.to(dtype), values.to(dtype)
    last_value = last_value.to(dtype)
    adv = torch.empty_like(rewards)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        not_done = 1.0 - done[t].to(dtype)
        delta = rewards[t] + gamma * next_value * not_done - values[t]
        gae = delta + gamma * lam * not_done * gae
        adv[t] = gae
        next_value = values[t]
    return adv


@functools.lru_cache(maxsize=None)
def _library():
    from marlnav_tpu_torch.ops._build import load_library

    lib, _ = load_library("returns")
    # Every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and cuts the pointer.
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.marlnav_returns.argtypes = ([ptr] * 4 + [i32, i32, f64, f64, i32,
                                                 i32, ptr, i32, ptr])
    lib.marlnav_returns.restype = i32
    return lib


def returns_scan(rewards: torch.Tensor, done: torch.Tensor, gamma: float,
                 values: Optional[torch.Tensor] = None,
                 last_value: Optional[torch.Tensor] = None,
                 lam: float = 1.0,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The discounted returns of ``rewards`` and ``done`` (T, P), or, with
    ``values`` (T, P) and ``last_value`` (P,), their GAE(``lam``)
    advantages, accumulated and returned in ``dtype`` (float32 or
    float64)."""
    gae = values is not None
    if rewards.device.type == "cpu":
        if gae:
            return gae_advantages_reference(rewards, done, values,
                                            last_value, gamma, lam, dtype)
        return discounted_returns_reference(rewards, done, gamma, dtype)
    from marlnav_tpu_torch.ops.fused_collect import _check

    device = rewards.device
    if device.type != "cuda":
        raise ValueError(f"returns: unsupported device {device}")
    if dtype not in _DTYPES or rewards.dim() != 2 or 0 in rewards.shape:
        raise ValueError(f"returns: need non-empty (T, P) rewards and dtype "
                         f"float32 or float64, got {tuple(rewards.shape)} "
                         f"and {dtype}")
    t, p = rewards.shape
    _check("rewards", rewards, (t, p), torch.float32, device)
    _check("done", done, (t, p), torch.bool, device)
    if gae:
        _check("values", values, (t, p), torch.float32, device)
        _check("last_value", last_value, (p,), torch.float32, device)
    out = torch.empty((t, p), dtype=dtype, device=device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = _library().marlnav_returns(
        rewards.data_ptr(), done.data_ptr(),
        values.data_ptr() if gae else None,
        last_value.data_ptr() if gae else None, t, p, float(gamma),
        float(gamma) * float(lam), int(gae), int(dtype == torch.float64),
        out.data_ptr(), index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"returns kernel launch failed: CUDA error {err}")
    returns_scan.launches += 1
    return out


returns_scan.launches = 0

