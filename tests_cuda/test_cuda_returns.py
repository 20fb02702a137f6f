"""The returns kernel (ops/csrc/returns.cu) against its plain loops on the
card: both perform the same float operations in the same order
(``-fmad=false``), so every value matches exactly, in float32 and float64,
discounted and GAE, with ``done`` on the first and the last step and at
ragged env counts."""

import pytest
import torch

from marlnav_tpu_torch.ops import returns as tr


def _inputs(t, p, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    rew = 100.0 * torch.randn((t, p), generator=g, device=device)
    done = torch.rand((t, p), generator=g, device=device) < 0.1
    done[0] = True
    done[-1, ::2] = True
    values = torch.randn((t, p), generator=g, device=device)
    last = torch.randn(p, generator=g, device=device)
    return rew, done, values, last


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("gae", [False, True], ids=["discounted", "gae"])
@pytest.mark.parametrize("shape", [(1000, 1024), (200, 333), (1, 7),
                                   (37, 7), (17, 64)],
                         ids=lambda s: f"T{s[0]}-P{s[1]}")
def test_kernel_matches_plain_loops_bit_for_bit(cuda, shape, gae, dtype):
    rew, done, values, last = _inputs(*shape, cuda)
    before = tr.returns_scan.launches
    if gae:
        got = tr.returns_scan(rew, done, 0.9, values, last, 0.95, dtype)
        want = tr.gae_advantages_reference(rew, done, values, last, 0.9,
                                           0.95, dtype)
    else:
        got = tr.returns_scan(rew, done, 0.99, dtype=dtype)
        want = tr.discounted_returns_reference(rew, done, 0.99, dtype)
    torch.cuda.synchronize()
    assert tr.returns_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrong_inputs_raise(cuda):
    rew, done, values, last = _inputs(8, 5, cuda)
    with pytest.raises(ValueError):
        tr.returns_scan(rew.double(), done, 0.9)
    with pytest.raises(ValueError):
        tr.returns_scan(rew, done.float(), 0.9)
    with pytest.raises(ValueError):
        tr.returns_scan(rew, done, 0.9, values, last[:4], 0.95)
    with pytest.raises(ValueError):
        tr.returns_scan(rew.T, done.T, 0.9)  # not contiguous
    with pytest.raises(ValueError):
        tr.returns_scan(rew, done, 0.9, dtype=torch.float16)
