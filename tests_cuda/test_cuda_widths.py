"""The kernels past their template instances, on the card: the collect
and rollout kernels' run-time obstacle count, the run-time-width route of
the critic and the un-collapsed actor gradients (float32 and bf16), and
the affine actor past obs 255.

The step kernels equal their plain versions bit for bit (every output
field, through resets with noisy_ags, at one env, part of a warp, a ragged
and a whole count), at every lane width their run-time instance has and
at the chooser's, as the templated instances do; at the most obstacles a
warp's groups take, and one past it raises.  The gradient route is held as the tensor-core
kernels are: float32 within 1e-4 max|w| + 1e-7 of the plain version in
float64, bf16 within a quarter of the plain version's bf16 - float32 gap,
output by output, two launches bitwise equal, one count a call; at ragged
row counts (one row, part of a warp's 16, part of a block's 128 and 200,003),
at an input past 1,000 columns (the backward's In-chunk axis) and at
4,000, and captured in a CUDA graph, whose replay
equals the eager call bit for bit.  Where one block holds all of H and In
the critic's route takes one pass, which equals its three launches bit for
bit.
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
from marlnav_tpu_torch.ops.graphs import CountedGraph
from marlnav_tpu_torch.ops.step_math import StepMath
from marlnav_tpu_torch.utils.seeding import make_generator

from test_cuda_bf16 import _check_bf16
from test_cuda_fused_update import (_margins, _sum_inputs,
                                    _uncollapsed_inputs)

N = 100_003
# (In, H) of the critic and (F, H) of the un-collapsed actor past the
# tensor-core instances; the affine actor's obs widths past 255.
CRITIC_WIDTHS = ((120, 50), (210, 64), (36, 512), (103, 257), (1040, 64))
UNCOLLAPSED_WIDTHS = ((40, 50), (70, 128), (12, 512), (1030, 64))
AFFINE_WIDTHS = (256, 300)


STEP_ENVS = (1, 7, 1000, 1024)


def step_setup(o, p, device, t=16, episode_len=10):
    """An env state of p envs with o obstacles (noisy resets), an actor
    operator and t steps of uniforms."""
    ep = EnvParams(num_parallel=p, num_obstacles=o, episode_len=episode_len)
    ic = TriangleInitConfig(num_parallel=p, num_obstacles=o, noisy_ags=True)
    sm = StepMath(ep, ic, NormalizerConfig(num_obstacles=o), ScalerConfig())
    rows = fc.env_state_to_rows(make_env(ep, ic, device).init(
        make_generator(1, device)))
    g = torch.Generator(device=device).manual_seed(2)
    a_comp = 0.1 * torch.randn(4, sm.obs_size, generator=g, device=device)
    c_comp = torch.randn(4, generator=g, device=device)
    noise = torch.rand((t, sm.n_draws, p), generator=g, device=device)
    return sm, rows, a_comp, c_comp, noise


def assert_collect_equal(out, ref, what):
    for name in ("obs", "actions", "log_probs", "rewards", "done", "stats"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), \
            (what, name)
    for x, y in zip(out.rows.fields(), ref.rows.fields()):
        assert torch.equal(x, y), what


def assert_rollout_equal(got, want, what):
    assert torch.equal(got[1], want[1]), what
    for x, y in zip(got[0].fields(), want[0].fields()):
        assert torch.equal(x, y), what


def slice_rows(rows, p):
    return fc.RowState(*(x[:, :p].contiguous() for x in rows.fields()))


@pytest.mark.cuda
@pytest.mark.parametrize("o", [9, 17, 32])
def test_collect_any_obstacle_count_matches_plain(cuda, o):
    """The collect kernel's run-time instance against
    collect_rows_reference at each lane width (forced through ``lanes``)
    and at the chooser's, at P 1, 7, 1000 and 1024, each P its own plain
    run: every field equal, the episode counters included (at a ragged P
    the groups past it count nothing), one count a launch."""
    for p in STEP_ENVS:
        sm, rows, a_comp, c_comp, noise = step_setup(o, p, cuda)
        ref = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
        for lanes in (None, *fc.COLLECT_RT_LANES):
            before = fc.fused_collect_rows.launches
            out = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9,
                                        noise.shape[0], noise, lanes=lanes)
            assert fc.fused_collect_rows.launches == before + 1
            torch.cuda.synchronize()
            what = f"P {p} lanes {lanes}"
            assert out.done.any(), what  # premise: resets fired
            assert_collect_equal(out, ref, what)


@pytest.mark.cuda
@pytest.mark.parametrize("o", [9, 17, 32])
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["sampled", "mean"])
def test_rollout_any_obstacle_count_matches_plain(cuda, o, deterministic):
    """The rollout kernel's run-time instance against
    rollout_rows_reference at each lane width and at the chooser's, at P 1,
    7, 1000 and 1024 (the first envs of one plain run): rewards and the
    final rows equal."""
    sm, rows, a_comp, c_comp, noise = step_setup(o, max(STEP_ENVS), cuda)
    want = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                     deterministic)
    for p in STEP_ENVS:
        rows_p, noise_p = slice_rows(rows, p), noise[..., :p].contiguous()
        for lanes in (None, *fr.ROLLOUT_RT_LANES):
            got = fr.fused_rollout_rows(sm, rows_p, a_comp, c_comp, 9,
                                        noise.shape[0], deterministic,
                                        noise_p, lanes=lanes)
            torch.cuda.synchronize()
            assert_rollout_equal(
                got, (slice_rows(want[0], p), want[1][:, :p]),
                f"P {p} lanes {lanes}")


@pytest.mark.cuda
@pytest.mark.parametrize("o", [9, 17, 32])
def test_rollout_and_collect_share_their_philox_stream_past_8(cuda, o):
    """A sampled rollout and a collect from the same seed give the same
    rewards and final rows, at every lane width of either, as at 1 .. 8."""
    sm, rows, a_comp, c_comp, _ = step_setup(o, 1000, cuda)
    col = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 5, 16)
    assert col.done.any()
    for lanes in fc.COLLECT_RT_LANES:
        other = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 5, 16,
                                      lanes=lanes)
        assert_collect_equal(other, col, f"collect lanes {lanes}")
    for lanes in fr.ROLLOUT_RT_LANES:
        ro = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 5, 16, False,
                                   lanes=lanes)
        torch.cuda.synchronize()
        assert_rollout_equal(ro, (col.rows, col.rewards),
                             f"rollout lanes {lanes}")


def most_obstacles(rt_smem, lanes, noisy=1):
    """The most obstacles whose groups of one warp at ``lanes`` lanes an env
    fit a block's shared memory (``rt_smem``: the library's)."""
    lo, hi = 9, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if rt_smem(mid, noisy, 32, lanes) >= 0 else \
            (lo, mid - 1)
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["collect", "rollout"])
def test_step_kernels_at_their_shared_memory_limit(cuda, kind):
    """At the most obstacles the narrowest width's warp takes (1,205 for
    the collect, 655 for the rollout with noisy resets), that width equals
    its plain version through resets (a reset every step); the chooser
    widens the groups past it, so the counts the kernels took before their
    run-time widths (up to 1,207 and 656) still run; one obstacle past what
    the widest width takes raises the ValueError that names the shared
    memory."""
    if kind == "collect":
        lib, widths = fc._library()[0], fc.COLLECT_RT_LANES
        rt_smem = lib.marlnav_collect_rt_smem
    else:
        lib, widths = fr._library(), fr.ROLLOUT_RT_LANES
        rt_smem = lib.marlnav_rollout_rt_smem
    o = most_obstacles(rt_smem, widths[0])
    sm, rows, a_comp, c_comp, noise = step_setup(o, 7, cuda, t=2,
                                                 episode_len=1)
    if kind == "collect":
        got = fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, 2, noise,
                                    lanes=widths[0])
        ref = fc.collect_rows_reference(sm, rows, a_comp, c_comp, noise)
        torch.cuda.synchronize()
        assert got.done.all()
        assert_collect_equal(got, ref, f"O {o}")
    else:
        got = fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 9, 2, False,
                                    noise, lanes=widths[0])
        want = fr.rollout_rows_reference(sm, rows, a_comp, c_comp, noise,
                                         False)
        torch.cuda.synchronize()
        assert_rollout_equal(got, want, f"O {o}")
    limits = [most_obstacles(rt_smem, w) for w in widths]
    assert limits == sorted(limits) and limits[0] >= (1205 if kind ==
                                                      "collect" else 655)
    for o, p in ((1207 if kind == "collect" else 656, 16384),
                 (limits[-1], 7)):
        sm = step_setup(o, 1, "cpu", t=1)[0]
        lanes, _ = fc.launch_shape(kind, sm, p, 8, rt_smem, 0, widths)
        assert lanes > widths[0] and rt_smem(o, 1, 32, lanes) >= 0
    sm, rows, a_comp, c_comp, _ = step_setup(limits[-1] + 1, 7, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        if kind == "collect":
            fc.fused_collect_rows(sm, rows, a_comp, c_comp, 9, 2)
        else:
            fr.fused_rollout_rows(sm, rows, a_comp, c_comp, 9, 2, False)


@pytest.mark.cuda
def test_graphed_collect_past_8_equals_eager(cuda):
    """The collect at 17 obstacles, at each lane width and the chooser's,
    captured in a CountedGraph: each replay equals the eager launch bit for
    bit, also after its device seed is rewritten, and counts one launch."""
    sm, rows, a_comp, c_comp, _ = step_setup(17, 1024, cuda)
    for lanes in (None, *fc.COLLECT_RT_LANES):
        seed = fc.seed_tensor(5, cuda)

        def run():
            return fc.fused_collect_rows(sm, rows, a_comp, c_comp, seed, 16,
                                         lanes=lanes)
        run()
        graph = CountedGraph()
        with graph.capture():
            out = run()
        for new_seed in (5, 6):
            seed.fill_(new_seed)
            before = fc.fused_collect_rows.launches
            graph.replay()
            assert fc.fused_collect_rows.launches == before + 1
            eager = run()
            torch.cuda.synchronize()
            assert_collect_equal(out, eager, f"lanes {lanes} seed {new_seed}")


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
@pytest.mark.parametrize("n_in,h", CRITIC_WIDTHS + ((36, 32), (36, 64),
                                                    (102, 256)))
def test_critic_runtime_route_bf16(cuda, n_in, h):
    """bf16 at every width: those past the float32 instances, and -hs 32
    (In 36, H 32), -hs 64 (In 36, H 64) and -no 14 -hs 256 (In 102, H
    256), which have float32 instances but no bf16 one."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 17, 63, 65, 200_003])
@pytest.mark.parametrize("kind", ["critic", "uncollapsed"])
def test_runtime_route_ragged_rows_match_float64(cuda, kind, n):
    """Row counts that leave a warp's 16 rows and a block's tile of 128
    ragged (critic In 120 / H 50, un-collapsed F 40 / H 50, -no 17)."""
    if kind == "critic":
        assert_float64(fu.critic_grad_sums, um.critic_grad_sums_reference,
                       (*critic_inputs(n, 120, 50, cuda), 0.2))
    else:
        assert_float64(fu.actor_grad_uncollapsed_sums,
                       um.actor_grad_sums_uncollapsed_reference,
                       (*_uncollapsed_inputs(n, 40, 50, cuda), 0.2, 0.001))


@pytest.mark.cuda
def test_runtime_route_at_input_4000(cuda):
    """Input width 4,000 (32 In chunks of the backward's grid): the route
    streams x and W1 through shared memory, so no width has to fit it
    whole."""
    assert_float64(fu.critic_grad_sums, um.critic_grad_sums_reference,
                   (*critic_inputs(5_003, 4000, 50, cuda), 0.2))
    assert_float64(fu.actor_grad_uncollapsed_sums,
                   um.actor_grad_sums_uncollapsed_reference,
                   (*_uncollapsed_inputs(5_003, 4000, 50, cuda), 0.2, 0.001))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_runtime_route_graphed_equals_eager(cuda, bf16):
    """Both gradients at run-time widths (critic In 120 / H 50, un-collapsed
    F 70 / H 128) captured in a CountedGraph: each replay equals the eager
    call bit for bit, on inputs rewritten in place between replays, and
    counts one launch a wrapper."""
    critic = (*critic_inputs(N, 120, 50, cuda), 0.2, bf16)
    actor = (*_uncollapsed_inputs(N, 70, 128, cuda), 0.2, 0.001, bf16)

    def both():
        return (fu.critic_grad_sums(*critic),
                fu.actor_grad_uncollapsed_sums(*actor))
    both()  # warm: the library built, the attributes set
    graph = CountedGraph()
    with graph.capture():
        out = both()
    for step in range(2):
        before = (fu.critic_grad_sums.launches,
                  fu.actor_grad_uncollapsed_sums.launches)
        graph.replay()
        assert (fu.critic_grad_sums.launches,
                fu.actor_grad_uncollapsed_sums.launches) == (
                    before[0] + 1, before[1] + 1)
        eager = both()
        torch.cuda.synchronize()
        for got, want in zip(out, eager):
            for x, y in zip(got, want):
                assert torch.equal(x, y), f"replay {step}"
        critic[4].mul_(0.5)  # obs: the next replay reads the new rows
        actor[6].mul_(0.5)


# (bf16, In, H) where the critic's route takes one pass: each precision,
# obstacles17.train's width and the widest In and H.
ONE_PASS_WIDTHS = ((False, 120, 50), (False, 104, 64), (True, 36, 64))
ONE_PASS_ROWS = (1, 127, 129, 200_003, 1_022_976)


def route_call(kind, n_in, h, inputs, bf16, n):
    """The route through the C entry on the first n rows of ``inputs``
    (``critic_inputs`` or ``_uncollapsed_inputs``), in the mode its
    argument takes: ``call(one_pass)`` -> the flat sums."""
    lib = fu._library()
    if kind == "critic":
        w1, b1, w2, b2, obs, vold, ret = inputs
        rows, head = (vold[:n], ret[:n], None), (w2, b2, None, None)
        eps, ppo, n_out = 0.2, (0.0,) * 4, 1 + h * n_in + 2 * h + 1
    else:
        w1, b1, *head, obs, act, lp, adv = inputs
        rows = (act[:n], lp[:n], adv[:n])
        eps, ppo = 0.0, (0.8, 1.2, 0.001, 0.0005)
        n_out = 1 + h * n_in + 5 * h + 4

    def call(one_pass):
        return fu._rt_grad_sums(lib, kind != "critic", obs[:n], rows, w1, b1,
                                head, n_in, h, eps, ppo, bf16, n_out,
                                one_pass)
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,n_in,h", ONE_PASS_WIDTHS)
def test_runtime_route_one_pass_equals_three_launches(cuda, bf16, n_in, h):
    """Through the C entry's mode argument, the critic's one-pass route
    equals its three launches bit for bit in every output, at one row,
    part of a tile, a tile and one row, 200,003 rows and
    obstacles17.train's 1,022,976; two one-pass launches are equal."""
    lib = fu._library()
    assert lib.marlnav_rt_one_pass(0, n_in, h)
    assert not lib.marlnav_critic_warps(n_in, h, int(bf16))
    inputs = critic_inputs(max(ONE_PASS_ROWS), n_in, h, cuda)
    for n in ONE_PASS_ROWS:
        call = route_call("critic", n_in, h, inputs, bf16, n)
        one, again, three = call(True), call(True), call(False)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(one).all()), n
        differ = (one != three).nonzero()[:8, 0].tolist()
        assert torch.equal(one, three), f"{n} rows: outputs {differ} differ"
        assert torch.equal(one, again), f"{n} rows: two one-pass launches"


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_in,h,one_pass", [
    ("critic", 120, 50, True), ("critic", 120, 65, False),
    ("critic", 129, 50, False), ("uncollapsed", 40, 50, False)])
def test_runtime_route_takes_one_pass_where_one_block_holds_h_and_in(
        cuda, kind, n_in, h, one_pass):
    """The critic's wrapper at In 120 / H 50 takes the one pass (its sums
    those of the C entry in one-pass mode, bit for bit) and counts it in
    ``rt_one_pass_launches``; at H 65 and at In 129 (one hidden unit or one
    column past a block), and for the un-collapsed actor at F 40 / H 50
    (whose one-pass instance spilled), ``rt_one_pass_launches`` does not
    move and the C entry refuses the one-pass mode, so the wrapper made the
    three launches."""
    lib = fu._library()
    actor = kind != "critic"
    assert bool(lib.marlnav_rt_one_pass(int(actor), n_in, h)) == one_pass
    if actor:
        fn = fu.actor_grad_uncollapsed_sums
        inputs = _uncollapsed_inputs(N, n_in, h, cuda)
        args = (*inputs, 0.2, 0.001)
    else:
        fn = fu.critic_grad_sums
        inputs = critic_inputs(N, n_in, h, cuda)
        args = (*inputs, 0.2)
    before = (fn.rt_launches, fn.rt_one_pass_launches)
    got = torch.cat([x.reshape(-1) for x in fn(*args)])
    assert (fn.rt_launches, fn.rt_one_pass_launches) == (
        before[0] + 1, before[1] + one_pass)
    call = route_call(kind, n_in, h, inputs, False, N)
    if one_pass:
        want = call(True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            call(True)
