"""The collect kernel (ops/csrc/fused_collect.cu) against its plain version
on the same uniforms: both perform the same float32 operations in the same
order (``-fmad=false``), so every output matches exactly, at a ragged env
count too."""

import pytest
import torch

from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator


@pytest.mark.cuda
@pytest.mark.parametrize("num_envs", [2048, 1000])
def test_kernel_matches_plain_on_card(cuda, num_envs):
    """The kernel against collect_rows_reference through resets
    (episode_len 10, noisy_ags): every field equal."""
    t, p = 32, num_envs
    ep = EnvParams(num_parallel=p, episode_len=10)
    ic = TriangleInitConfig(num_parallel=p, noisy_ags=True)
    sm = StepMath(ep, ic, NormalizerConfig(), ScalerConfig())
    rows = fc.env_state_to_rows(make_env(ep, ic, cuda).init(
        make_generator(1, cuda)))
    g = torch.Generator(device=cuda).manual_seed(2)
    a_comp = 0.1 * torch.randn(4, 12, generator=g, device=cuda)
    c_comp = torch.randn(4, generator=g, device=cuda)
    noise = torch.rand((t, sm.n_draws, p), generator=g, device=cuda)
    out = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, t, noise)
    ref = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
    torch.cuda.synchronize()
    assert out.done.any()  # premise: resets fired
    for name in ("obs", "actions", "log_probs", "rewards", "done", "stats"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for x, y in zip(out.rows.fields(), ref.rows.fields()):
        assert torch.equal(x, y)
