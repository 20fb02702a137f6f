"""The kernels past their template instances, on the card: the collect
and rollout kernels' run-time obstacle count, the run-time-width route of
the critic and the un-collapsed actor gradients (float32 and bf16), and
the affine actor past obs 255.

The step kernels equal their plain versions bit for bit (every output
field, through resets with noisy_ags, at a ragged env count too), as the
templated instances do.  The gradient route is held as the tensor-core
kernels are: float32 within 1e-4 max|w| + 1e-7 of the plain version in
float64, bf16 within a quarter of the plain version's bf16 - float32 gap,
output by output, two launches bitwise equal, one count a call.
"""

import pytest
import torch

from marlnav_tpu_torch.config import (EnvParams, NormalizerConfig,
                                      ScalerConfig, TriangleInitConfig)
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.ops import fused_collect as fc
from marlnav_tpu_torch.ops import fused_rollout as fr
from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import update_math as um
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator

from test_cuda_bf16 import _check_bf16
from test_cuda_fused_update import (_margins, _sum_inputs,
                                    _uncollapsed_inputs)

N = 100_003
# (In, H) of the critic and (F, H) of the un-collapsed actor past the
# tensor-core instances; the affine actor's obs widths past 255.
CRITIC_WIDTHS = ((120, 50), (210, 64), (36, 512), (103, 257))
UNCOLLAPSED_WIDTHS = ((40, 50), (70, 128), (12, 512))
AFFINE_WIDTHS = (256, 300)


def step_setup(o, p, device, t=16):
    """An env state of p envs with o obstacles (episode_len 10, noisy
    resets), an actor operator and t steps of uniforms."""
    ep = EnvParams(num_parallel=p, num_obstacles=o, episode_len=10)
    ic = TriangleInitConfig(num_parallel=p, num_obstacles=o, noisy_ags=True)
    sm = StepMath(ep, ic, NormalizerConfig(num_obstacles=o), ScalerConfig())
    rows = fc.env_state_to_rows(make_env(ep, ic, device).init(
        make_generator(1, device)))
    g = torch.Generator(device=device).manual_seed(2)
    a_comp = 0.1 * torch.randn(4, sm.obs_size, generator=g, device=device)
    c_comp = torch.randn(4, generator=g, device=device)
    noise = torch.rand((t, sm.n_draws, p), generator=g, device=device)
    return sm, rows, a_comp, c_comp, noise


@pytest.mark.cuda
@pytest.mark.parametrize("o", [9, 17, 32])
@pytest.mark.parametrize("num_envs", [2048, 1000])
def test_collect_any_obstacle_count_matches_plain(cuda, o, num_envs):
    """The collect kernel's run-time instance against
    collect_rows_reference: every field equal, one count a launch."""
    sm, rows, a_comp, c_comp, noise = step_setup(o, num_envs, cuda)
    before = fc.fused_collect_rows.launches
    out = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, noise.shape[0],
                                noise)
    assert fc.fused_collect_rows.launches == before + 1
    ref = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
    torch.cuda.synchronize()
    assert out.done.any()  # premise: resets fired
    for name in ("obs", "actions", "log_probs", "rewards", "done", "stats"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for x, y in zip(out.rows.fields(), ref.rows.fields()):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("o", [9, 17, 32])
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["sampled", "mean"])
def test_rollout_any_obstacle_count_matches_plain(cuda, o, deterministic):
    """The rollout kernel's run-time instance against
    rollout_rows_reference, at a ragged env count: rewards and the final
    rows equal."""
    sm, rows, a_comp, c_comp, noise = step_setup(o, 1000, cuda)
    got = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 9, noise.shape[0],
                                deterministic, noise)
    want = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                     deterministic)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for x, y in zip(got[0].fields(), want[0].fields()):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_rollout_and_collect_share_their_philox_stream_past_8(cuda):
    """A sampled rollout and a collect from the same seed give the same
    rewards and final rows at 17 obstacles, as at 1 .. 8."""
    sm, rows, a_comp, c_comp, _ = step_setup(17, 1000, cuda)
    col = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 5, 16)
    ro = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 5, 16, False)
    torch.cuda.synchronize()
    assert torch.equal(col.rewards, ro[1])
    for x, y in zip(col.rows.fields(), ro[0].fields()):
        assert torch.equal(x, y)


def critic_inputs(n, n_in, h, device, seed=7):
    """Critic inputs at any input width, drawn as _sum_inputs draws them:
    pre-activations spread about 0.5 against hidden biases of +-3, old
    values a margin from the network's own (eps 0.2)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w1, b1 = 0.5 * r(h, n_in) / n_in ** 0.5, 3.0 * torch.sign(r(h))
    w2, b2, obs = r(1, h) / h ** 0.5, r(1), r(n, n_in)
    v = torch.relu(obs @ w1.T + b1) @ w2[0] + b2
    xs = (w1, b1, w2, b2, obs, v + _margins(r, n), r(n))
    return tuple(x.to(device) for x in xs)


def assert_float64(kernel, plain, args):
    """float32 within 1e-4 max|w| + 1e-7 of float64, two launches equal,
    one count each."""
    before = kernel.launches
    got, again = kernel(*args), kernel(*args)
    assert kernel.launches == before + 2
    want = plain(*(x.double() if torch.is_tensor(x) else x for x in args))
    torch.cuda.synchronize()
    for i, (k, k2, w) in enumerate(zip(got, again, want)):
        assert torch.equal(k, k2), f"output {i}: two launches differ"
        tol = 1e-4 * float(w.abs().max()) + 1e-7
        err = float((k.double() - w).abs().max())
        assert err <= tol, f"output {i}: error {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,h", CRITIC_WIDTHS)
def test_critic_runtime_route_matches_float64(cuda, n_in, h):
    lib = fu._library()
    assert not lib.marlnav_critic_warps(n_in, h, 0)  # premise: no instance
    assert_float64(fu.critic_grad_sums, um.critic_grad_sums_reference,
                   (*critic_inputs(N, n_in, h, cuda), 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("f,h", UNCOLLAPSED_WIDTHS)
def test_uncollapsed_runtime_route_matches_float64(cuda, f, h):
    lib = fu._library()
    assert not lib.marlnav_uncollapsed_warps(f, h, 0)
    assert_float64(fu.actor_grad_uncollapsed_sums,
                   um.actor_grad_sums_uncollapsed_reference,
                   (*_uncollapsed_inputs(N, f, h, cuda), 0.2, 0.001))


@pytest.mark.cuda
@pytest.mark.parametrize("f", AFFINE_WIDTHS)
def test_affine_past_255_matches_float64(cuda, f):
    """The affine actor at obs 256 and 300 (32-row tiles), on all rows and
    on a slice that starts off 16 bytes."""
    a_comp, c_comp, obs, act, lp, adv = _sum_inputs(N, f, 50, cuda)[0]
    assert_float64(fu.actor_grad_sums, um.actor_grad_sums_reference,
                   (a_comp, c_comp, obs, act, lp, adv, 0.2, 0.001))
    assert_float64(fu.actor_grad_sums, um.actor_grad_sums_reference,
                   (a_comp, c_comp, obs[1:], act[1:], lp[1:], adv[1:], 0.2,
                    0.001))


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,h", CRITIC_WIDTHS + ((36, 32), (102, 256)))
def test_critic_runtime_route_bf16(cuda, n_in, h):
    """bf16 at every width: those past the float32 instances, and -hs 32
    (In 36, H 32) and -no 14 -hs 256 (In 102, H 256), which have float32
    instances but no bf16 one."""
    before = fu.critic_grad_sums.launches
    _check_bf16(fu.critic_grad_sums, um.critic_grad_sums_reference,
                (*critic_inputs(N, n_in, h, cuda), 0.2), True,
                f"critic In {n_in} H {h}")
    assert fu.critic_grad_sums.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("f,h", UNCOLLAPSED_WIDTHS + ((12, 32), (34, 256)))
def test_uncollapsed_runtime_route_bf16(cuda, f, h):
    _check_bf16(fu.actor_grad_uncollapsed_sums,
                um.actor_grad_sums_uncollapsed_reference,
                (*_uncollapsed_inputs(N, f, h, cuda), 0.2, 0.001), True,
                f"un-collapsed F {f} H {h}")
