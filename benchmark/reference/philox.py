"""Philox4x32-10 uniforms in plain PyTorch integer arithmetic.

The collect and rollout kernels draw their random numbers from
Philox4x32-10 (Salmon et al., SC'11) keyed on (seed, env) with the counter
(step, draw group, 0, 0): four uniforms a group, draw ``4 d + q`` from word
``q`` of group ``d``.  A word becomes a uniform in [0, 1) by its top 24
bits, read as a signed 32-bit integer and shifted arithmetically, times
2**-24, plus 0.5: exact in float32.

The 32-bit words are held in int64 tensors.  A 32 x 32-bit product does
not fit int64, so ``_mulhilo`` splits the variable factor into 16-bit
halves.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    32-bit words ``b`` (int64)."""
    p_lo = a * (b & 0xFFFF)  # < 2**48
    p_hi = a * (b >> 16)  # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 at counter (c0, c1, c2, c3)
    and key (k0, k1), every argument int64 words (broadcast together)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def bits_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 from 32-bit words held in int64."""
    signed = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (signed >> 8).to(torch.float32) * (1.0 / 16777216.0) + 0.5


def uniforms(seed: int, num_envs: int, num_steps: int, n_draws: int,
             device, first_env: int = 0, step_chunk: int = 64
             ) -> torch.Tensor:
    """(num_steps, n_draws, num_envs) float32 uniforms of envs
    ``first_env ..`` under the kernel seed ``seed`` (its low 32 bits)."""
    groups = -(-n_draws // 4)
    out = torch.empty((num_steps, n_draws, num_envs), dtype=torch.float32,
                      device=device)
    i64 = dict(dtype=torch.int64, device=device)
    env = torch.arange(first_env, first_env + num_envs, **i64)[None, None, :]
    d = torch.arange(groups, **i64)[None, :, None]
    k0 = torch.full((), int(seed) & _MASK, **i64)
    zero = torch.zeros((), **i64)
    for t0 in range(0, num_steps, step_chunk):
        t1 = min(num_steps, t0 + step_chunk)
        t = torch.arange(t0, t1, **i64)[:, None, None]
        words = philox4x32_10(t.expand(-1, groups, num_envs),
                              d.expand(t1 - t0, -1, num_envs), zero, zero,
                              k0, env)
        block = torch.stack([bits_to_uniform(w) for w in words], 2)
        out[t0:t1] = block.reshape(t1 - t0, 4 * groups, num_envs)[:, :n_draws]
    return out
