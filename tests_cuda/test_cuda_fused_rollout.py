"""The bench rollout kernel (ops/csrc/fused_rollout.cu) against its plain
version on the same uniforms in both modes, and the sampled kernel against
the collect kernel from the same Philox seed: every output matches
exactly, at a ragged env count too."""

import pytest
import torch

from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_rollout as fr
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator


@pytest.mark.cuda
@pytest.mark.parametrize("num_envs", [2048, 1000])
def test_kernel_matches_plain_on_card(cuda, num_envs):
    """Rewards and final rows equal those of rollout_rows_reference (both
    modes) and, sampled, those of the collect kernel."""
    t, p = 32, num_envs
    ep = EnvParams(num_parallel=p, episode_len=10)
    ic = TriangleInitConfig(num_parallel=p, noisy_ags=True)
    sm = StepMath(ep, ic, NormalizerConfig(), ScalerConfig())
    rows = fr.env_state_to_rows(make_env(ep, ic, cuda).init(
        make_generator(1, cuda)))
    g = torch.Generator(device=cuda).manual_seed(2)
    a_comp = 0.1 * torch.randn(4, 12, generator=g, device=cuda)
    c_comp = torch.randn(4, generator=g, device=cuda)
    noise = torch.rand((t, sm.n_draws, p), generator=g, device=cuda)
    for deterministic in (False, True):
        got = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 9, t,
                                    deterministic, noise)
        want = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                         deterministic)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert all(torch.equal(x, y) for x, y in zip(got[0].fields(),
                                                     want[0].fields()))
    col = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, t)
    rows_k, rew_k = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 9, t,
                                          False)
    torch.cuda.synchronize()
    assert torch.equal(rew_k, col.rewards)
    assert all(torch.equal(x, y) for x, y in zip(rows_k.fields(),
                                                 col.rows.fields()))
