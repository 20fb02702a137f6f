"""The port's returns (``ops/returns.py``, ``algo.mappo`` returns) against
the JAX package's sequential scans, on numpy-seeded inputs, plus the CPU
routing of the returns kernel's wrapper and the arithmetic rule its CUDA
source keeps.

Both sides run the same sequential recursion in the same precision, so
they agree to rounding: rtol 1e-6 against the JAX values (with an absolute
floor of 1e-6 of the largest magnitude, for values that cross zero).  The
whole-buffer mean and sample std reduce in another order in each
framework: 1e-6 too.  ``--returns-f64`` runs against the JAX package's
float64 path with x64 switched on only inside the test (the pattern of
tests/test_mappo.py:216-220), so no other test sees x64.

The CUDA kernel cannot run here; ``tests_cuda/test_cuda_returns.py`` and
``chip_smoke.py`` hold it against these plain loops bit for bit on the
card.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlnav_tpu.algo import mappo as jm
from marlnav_tpu.config import MAPPOConfig as JMAPPOConfig
from marlnav_tpu_torch.algo import mappo as tm
from marlnav_tpu_torch.config import MAPPOConfig
from marlnav_tpu_torch.ops import returns as tr

SHAPES = [(1, 5), (13, 7), (40, 33)]  # T 1, ragged P, more than a warp


def _inputs(t, p, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=scale, size=(t, p)).astype(np.float32),
            rng.uniform(size=(t, p)) < 0.2,
            rng.normal(size=(t, p)).astype(np.float32),
            rng.normal(size=p).astype(np.float32))


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _cfgs(t, p, **kw):
    base = dict(num_agents=3, num_parallel=p, obs_size=12, hidden_size=16,
                num_total=t * p, buffer_len=t, num_epochs=2, batch_size=t)
    base.update(kw)
    return JMAPPOConfig(**base), MAPPOConfig(**base)


@pytest.mark.parametrize("gamma", [0.9, 0.99])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}-P{s[1]}")
def test_discounted_returns_match_jax(shape, gamma):
    rew, done, _, _ = _inputs(*shape)
    got = tm.discounted_returns(torch.tensor(rew), torch.tensor(done), gamma)
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got.numpy(), jm.discounted_returns(jnp.asarray(rew),
                                              jnp.asarray(done), gamma))


@pytest.mark.parametrize("gamma", [0.9, 0.99])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}-P{s[1]}")
def test_reference_returns_match_jax(shape, gamma):
    rew, done, _, _ = _inputs(*shape, seed=1)
    jc, tc = _cfgs(*shape, gamma=gamma)
    n_t, m_t = tm.reference_returns(torch.tensor(rew), torch.tensor(done), tc)
    n_j, m_j = jm.reference_returns(jnp.asarray(rew), jnp.asarray(done), jc)
    assert n_t.dtype == m_t.dtype == torch.float32
    np.testing.assert_allclose(float(m_t), float(m_j), rtol=1e-6)
    _close(n_t.numpy(), n_j)


@pytest.mark.parametrize("gamma,lam", [(0.9, 0.95), (0.99, 1.0), (0.95, 0.0)])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}-P{s[1]}")
def test_gae_advantages_match_jax(shape, gamma, lam):
    rew, done, values, last = _inputs(*shape, seed=2)
    got = tm.gae_advantages(torch.tensor(rew), torch.tensor(done),
                            torch.tensor(values), torch.tensor(last), gamma,
                            lam)
    assert got.dtype == torch.float32
    _close(got.numpy(), jm.gae_advantages(
        jnp.asarray(rew), jnp.asarray(done), jnp.asarray(values),
        jnp.asarray(last), gamma, lam))


def test_returns_f64_matches_jax_float64_path():
    """returns_f64: float64 accumulation, mean and std (the reference's
    accumulator), against the JAX package's reference_returns under x64,
    at reward magnitudes (~1e3) where the float32 path deviates visibly."""
    t, p = 400, 8
    rew, done, _, _ = _inputs(t, p, seed=3, scale=1000.0)
    done = np.random.default_rng(4).uniform(size=(t, p)) < 0.01
    jc, tc = _cfgs(t, p, returns_f64=True)
    n_t, m_t = tm.reference_returns(torch.tensor(rew), torch.tensor(done), tc)
    try:
        jax.config.update("jax_enable_x64", True)
        n_j, m_j = jax.jit(jm.reference_returns, static_argnums=2)(
            jnp.asarray(rew), jnp.asarray(done), jc)
        n_j, m_j = np.asarray(n_j), float(m_j)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert n_t.dtype == torch.float32 and m_t.dtype == torch.float64
    np.testing.assert_allclose(float(m_t), m_j, rtol=1e-12)
    _close(n_t.numpy(), n_j)
    # The float32 path is another result at this scale.
    n_32, _ = tm.reference_returns(torch.tensor(rew), torch.tensor(done),
                                   dataclasses.replace(tc, returns_f64=False))
    assert not torch.equal(n_32, n_t)


@pytest.mark.parametrize("gae", [False, True], ids=["discounted", "gae"])
def test_float64_loops_match_numpy_float64(gae):
    """The plain float64 loops (the kernel's float64 instances' plain
    versions) perform numpy's float64 recursion operation for operation."""
    t, p, gamma, lam = 30, 9, 0.97, 0.9
    rew, done, values, last = _inputs(t, p, seed=5)
    r, v = rew.astype(np.float64), values.astype(np.float64)
    want, carry, nv = np.zeros((t, p)), np.zeros(p), last.astype(np.float64)
    for i in range(t - 1, -1, -1):
        if gae:
            nd = 1.0 - done[i].astype(np.float64)
            carry = (r[i] + gamma * nv * nd - v[i]) + gamma * lam * nd * carry
            nv = v[i]
        else:
            carry = np.where(done[i], 0.0, r[i] + gamma * carry)
        want[i] = carry
    args = (torch.tensor(rew), torch.tensor(done), gamma)
    got = (tr.returns_scan(*args, torch.tensor(values), torch.tensor(last),
                           lam, torch.float64) if gae else
           tr.returns_scan(*args, dtype=torch.float64))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_routing_runs_plain_loops_and_launches_nothing():
    rew, done, values, last = (torch.tensor(x) for x in _inputs(6, 5))
    before = tr.returns_scan.launches
    assert torch.equal(tr.returns_scan(rew, done, 0.9),
                       tr.discounted_returns_reference(rew, done, 0.9))
    assert torch.equal(
        tr.returns_scan(rew, done, 0.9, values, last, 0.95),
        tr.gae_advantages_reference(rew, done, values, last, 0.9, 0.95))
    assert tr.returns_scan.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tr.returns_scan(rew.to("meta"), done.to("meta"), 0.9)


# Intrinsics that compute something other than the IEEE operation the
# plain loops perform (approximate or fused), and the flag that turns them
# on everywhere (tests/test_torch_fused_collect.py keeps the same rule for
# the env-step sources).
_FAST_MATH = re.compile(
    r"\b(__fdividef|__expf|__exp10f|__logf|__log2f|__log10f|__sinf|__cosf"
    r"|__sincosf|__tanf|__powf|__fmaf_\w+|__fma_\w+|fmaf?)\s*\(")


def test_returns_source_keeps_plain_arithmetic():
    """The returns kernel equals its plain loops bit for bit only if every
    multiply and add rounds on its own: the build keeps -fmad=false and no
    fast math, and returns.cu calls no fast-math intrinsic and no explicit
    fused multiply-add, in float or in double."""
    from marlnav_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in _build.NVCC_FLAGS, flags
    assert "fast_math" not in flags and "fast-math" not in flags, flags
    with open(os.path.join(_build.CSRC, "returns.cu")) as fh:
        code = re.sub(r"//[^\n]*", "", fh.read())
    assert "#include" in code and "returns_kernel" in code
    assert not _FAST_MATH.findall(code), _FAST_MATH.findall(code)
    assert re.findall(r'#include "', code) == []  # no header brings any in
    # the pattern does catch what it must
    assert len(_FAST_MATH.findall("a = fma(x, y, z) + __fmaf_rn(a, b, c) "
                                  "+ __expf(x) + fmaf(a, b, c);")) == 4
