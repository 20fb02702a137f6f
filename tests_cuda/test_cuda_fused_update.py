"""The fused-update kernels (ops/csrc/fused_update.cu) against their plain
PyTorch versions (ops/update_math.py) run in float64, on the card: each
output within 1e-4 of its largest magnitude (+1e-6), and two launches
bitwise equal.  The kernels sum in another order than the plain versions
(and the tensor-core ones in 3xTF32), so they are held against float64,
not bit for bit.

Cases: the default widths and those of -no 8 (F 22), -no 14 (F 34, critic
In 102), -hs 128 and -hs 256, hidden sizes between passes of the
tensor-core body (200), ragged row counts, the affine actor at odd and
wide obs widths and on row slices that start off 16 bytes, and the widths
past each kernel's limits, which raise (tests_cuda/test_cuda_widths.py
holds the widths between).

Those inputs keep every row a margin from the clip edges and the ReLU's
kink (wider networks put more rows near them).
``test_kernels_match_plain_on_unshaped_inputs`` holds the kernels to the
same tolerance on inputs drawn with no such margin (eps 0.01, log-probs
and old values apart from the networks) at the default widths and those
of -no 8 and -hs 128; run with ``-s`` it prints each output's error
beside the float32 plain version's.
"""

import math

import pytest
import torch

from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import update_math as um

A, OBS = 3, 12


def _margins(r, n):
    """n offsets of -0.4, -0.05, 0.05 or 0.4: behaviour log-probs (or old
    values) that far from the network's own put each row well inside or
    well outside the clip band of eps 0.2 (ratios 0.67, 0.95, 1.05, 1.49),
    never on its edge, where float32 and float64 may take different sides
    of a clip or a min and the row's gradient jumps."""
    return torch.tensor([-0.4, -0.05, 0.05, 0.4])[
        (r(n).abs() * 1e4).long() % 4]


def _behaviour_log_probs(z, act, r):
    """The log-probs of actions under the head pre-activations z (N, 4),
    each moved by a margin."""
    var = torch.nn.functional.softplus(z[:, 2:])
    return _margins(r, z.shape[0]) - 0.5 * (
        2.0 * math.log(2.0 * math.pi) + torch.log(var).sum(1)
        + ((act - torch.tanh(z[:, :2])) ** 2 / var).sum(1))


def _sum_inputs(n, f, h, device="cpu", seed=7):
    """(affine actor inputs, critic inputs) of n rows, for eps 0.2: the
    operator (4, F) and the critic's weights scaled with their fan-in (the
    pre-activations spread about 0.5), the behaviour log-probs and the old
    values a margin from the networks' own."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    a_comp, c_comp, x = 0.15 * (12 / f) ** 0.5 * r(4, f), 0.3 * r(4), r(n, f)
    act = r(n, 2).clamp(-1, 1)
    lp = _behaviour_log_probs(x @ a_comp.T + c_comp, act, r)
    actor = (a_comp, c_comp, x, act, lp, r(n))
    # Hidden biases of +-3 against pre-activation spreads of 0.5: no unit
    # sits near the ReLU's kink, where a rounding would flip relu'.
    w1, b1 = 0.5 * r(h, A * f) / (A * f) ** 0.5, 3.0 * torch.sign(r(h))
    w2, b2, obs = r(1, h) / h ** 0.5, r(1), r(n, A * f)
    v = torch.relu(obs @ w1.T + b1) @ w2[0] + b2
    critic = (w1, b1, w2, b2, obs, v + _margins(r, n), r(n))
    to = lambda xs: tuple(x.to(device) for x in xs)  # noqa: E731
    return to(actor), to(critic)


def _uncollapsed_inputs(n, f, h, device="cpu", seed=8):
    """Weights in nn.Linear layout (w1, b1, wmu, bmu, wvar, bvar), then
    obs, actions, log-probs and advantages of n rows.  The weights' scale
    falls with the fan-in, so that the heads' pre-activations keep a
    spread of about 0.5 at every width (a variance near 0 would make a
    row's gradient, and float32's error on it, explode); the behaviour
    log-probs are a margin from the network's own (eps 0.2)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    s1, s2 = 0.3 * (12 / f) ** 0.5, 0.5 / h ** 0.5
    w = (s1 * r(h, f), 0.1 * r(h), s2 * r(2, h), 0.1 * r(2), s2 * r(2, h),
         0.1 * r(2))
    x, act = r(n, f), r(n, 2).clamp(-1, 1)
    hid = x @ w[0].T + w[1]
    z = torch.cat([hid @ w[2].T + w[3], hid @ w[4].T + w[5]], dim=1)
    xs = (*w, x, act, _behaviour_log_probs(z, act, r), r(n))
    return tuple(x_.to(device) for x_ in xs)


def assert_matches_float64(kernel, plain, args):
    got, again = kernel(*args), kernel(*args)
    want = plain(*(x.double() if torch.is_tensor(x) else x for x in args))
    torch.cuda.synchronize()
    for i, (k, k2, w) in enumerate(zip(got, again, want)):
        assert torch.equal(k, k2), f"output {i}: two launches differ"
        tol = 1e-4 * float(w.abs().max()) + 1e-6
        err = float((k.double() - w).abs().max())
        assert err <= tol, f"output {i}: error {err} > {tol}"


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    """The affine actor and the critic kernels at the default widths and at
    those of -no 8 (F 22), -hs 128, -hs 256 and -no 14 with -hs 256 (F 34,
    critic In 102), on 100,003 rows (the last tile and chunk ragged)."""
    for f, h in ((OBS, 50), (22, 50), (OBS, 128), (32, 128), (OBS, 256),
                 (34, 256), (OBS, 200)):
        actor_in, critic_in = _sum_inputs(100_003, f, h, cuda)
        assert_matches_float64(fu.actor_grad_sums,
                               um.actor_grad_sums_reference,
                               (*actor_in, 0.2, 0.001))
        assert_matches_float64(fu.critic_grad_sums,
                               um.critic_grad_sums_reference,
                               (*critic_in, 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 13, 34, 64, 255])
def test_affine_kernel_at_any_obs_width(cuda, f):
    """The affine actor at odd, wide and the widest obs widths it takes,
    over row counts of one row, part of a tile, a tile and one more row,
    and many tiles; and on slices whose first row starts off 16 bytes
    (odd F) with actions off 16 bytes, as a minibatch slice may."""
    actor_in, _ = _sum_inputs(50_001, f, 50, cuda)
    a_comp, c_comp, obs, act, lp, adv = actor_in
    rows = fu._library().marlnav_actor_tile_rows(f)
    for n in (1, 31, rows + 1, 50_001):
        assert_matches_float64(
            fu.actor_grad_sums, um.actor_grad_sums_reference,
            (a_comp, c_comp, obs[:n], act[:n], lp[:n], adv[:n], 0.2, 0.001))
    for start in (1, 3):
        assert_matches_float64(
            fu.actor_grad_sums, um.actor_grad_sums_reference,
            (a_comp, c_comp, obs[start:], act[start:], lp[start:],
             adv[start:], 0.2, 0.001))


@pytest.mark.cuda
def test_uncollapsed_kernel_matches_plain_on_card(cuda):
    """The un-collapsed kernel at F 12 / H 50, F 22 / H 128, F 32 / H 128,
    and past 128 hidden units (two passes of the tensor-core body): F 12 /
    H 256, F 34 / H 256 and F 39 / H 200."""
    for f, h in ((OBS, 50), (22, 128), (32, 128), (OBS, 256), (34, 256),
                 (39, 200)):
        assert_matches_float64(
            fu.actor_grad_uncollapsed_sums,
            um.actor_grad_sums_uncollapsed_reference,
            (*_uncollapsed_inputs(100_003, f, h, cuda), 0.2, 0.001))


@pytest.mark.cuda
def test_widths_past_the_limits_raise_on_the_card(cuda):
    """Past its widths each wrapper raises ValueError naming them: the
    affine actor past obs 1023, and the run-time-width route of the critic
    and the un-collapsed actor where one block's shared memory cannot hold
    a tile of rows (input width 4000)."""
    lib = fu._library()
    max_f = lib.marlnav_actor_max_obs()
    actor_in, _ = _sum_inputs(64, max_f + 1, 50, cuda)
    with pytest.raises(ValueError, match=f"1..{max_f}"):
        fu.actor_grad_sums(*actor_in, 0.2, 0.001)
    w1, b1, w2, b2, _, vold, ret = _sum_inputs(64, OBS, 50, cuda)[1]
    wide = torch.zeros((50, 4000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fu.critic_grad_sums(wide, b1, w2, b2,
                            torch.zeros((64, 4000), device=cuda), vold, ret,
                            0.2)
    args = list(_uncollapsed_inputs(64, OBS, 50, cuda))
    args[0], args[6] = wide, torch.zeros((64, 4000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fu.actor_grad_uncollapsed_sums(*args, 0.2, 0.001)


def _unshaped_inputs(kind, n, f, h, device):
    """Inputs drawn with no regard to the clip edges or the ReLU's kink:
    behaviour log-probs ~ N(-1, 0.5) and old values ~ N(0, 1) apart from
    the networks, unscaled biases, for eps 0.01."""
    g = torch.Generator().manual_seed({"affine": 7, "critic": 7,
                                       "uncollapsed": 8}[kind])
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    if kind == "uncollapsed":
        s1, s2 = 0.3 * (12 / f) ** 0.5, 0.3 * (50 / h) ** 0.5
        xs = (s1 * r(h, f), 0.1 * r(h), s2 * r(2, h), 0.1 * r(2),
              s2 * r(2, h), 0.1 * r(2), r(n, f), r(n, 2).clamp(-1, 1),
              -1.0 + 0.5 * r(n), r(n))
    else:
        actor = (0.3 * r(4, f), r(4), r(n, f), r(n, 2).clamp(-1, 1),
                 -1.0 + 0.5 * r(n), r(n))
        xs = actor if kind == "affine" else (
            r(h, A * f) / 6.0, r(h), r(1, h) / 7.0, r(1), r(n, A * f), r(n),
            r(n))
    return tuple(x.to(device) for x in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["affine", "critic", "uncollapsed"])
def test_kernels_match_plain_on_unshaped_inputs(cuda, kind):
    """On 100,003 unshaped rows (eps 0.01) at the default widths and those
    of -no 8 and -hs 128, each output of each kernel within 1e-4 of its
    largest magnitude (+1e-6) of float64, and two launches bitwise
    equal."""
    kernel, plain, widths = {
        "affine": (fu.actor_grad_sums, um.actor_grad_sums_reference,
                   ((OBS, 50), (22, 50), (OBS, 128), (32, 128))),
        "critic": (fu.critic_grad_sums, um.critic_grad_sums_reference,
                   ((OBS, 50), (22, 50), (OBS, 128), (32, 128))),
        "uncollapsed": (fu.actor_grad_uncollapsed_sums,
                        um.actor_grad_sums_uncollapsed_reference,
                        ((OBS, 50), (22, 128), (32, 128)))}[kind]
    consts = (0.01,) if kind == "critic" else (0.01, 0.001)
    for f, h in widths:
        args = (*_unshaped_inputs(kind, 100_003, f, h, cuda), *consts)
        got, again, p32 = kernel(*args), kernel(*args), plain(*args)
        want = plain(*(x.double() if torch.is_tensor(x) else x
                       for x in args))
        torch.cuda.synchronize()
        for i, (k, k2, q, w) in enumerate(zip(got, again, p32, want)):
            assert torch.equal(k, k2), f"F {f} H {h} output {i}: two " \
                "launches differ"
            tol = 1e-4 * float(w.abs().max()) + 1e-6
            err = float((k.double() - w).abs().max())
            err32 = float((q.double() - w).abs().max())
            print(f"{kind} F {f} H {h} output {i}: kernel {err:.3e}, plain "
                  f"float32 {err32:.3e}, tolerance {tol:.3e}")
            assert err <= tol, (f"F {f} H {h} output {i}: error {err} > "
                                f"{tol} (plain float32 {err32})")
