"""The fused-update kernels' bf16 variants (``--bf16-updates``) against
their plain PyTorch versions in bf16 mode, on the card.

Each kernel rounds the operands of its products to bf16 where the JAX
route it stands for does (ops/update_math.py); its plain version rounds at
the same points.  The criterion, output by output: |kernel - plain_bf16|
<= 1/4 |plain_bf16 - plain_f32| (max norms), the plain versions on the
card on the same inputs; what the rounding moves is the gap, and the
kernel's own float32 sums (another order, the tensor cores' accumulation)
lie far inside it.  The tiled affine actor's loss has no gap (its forward
is unrounded) and is held to 1e-4 of its magnitude.  Two launches are
bitwise equal.  With ``-s`` each output's error against float64 products
of the same bf16-rounded operands (``acc=torch.float64``) is printed: for
the tensor-core kernels, their accumulation's error alone.

Cases: the widths training reaches, each a bf16 instance: the default,
-no 8 (critic In 66, actor F 22), -no 14 (In 102, F 34), -hs 128 and -hs
256, on 100,003 rows (the last chunk ragged); widths with no bf16
instance raise ValueError.
"""

import pytest
import torch

from marlnav_tpu_torch.ops import fused_update as fu
from marlnav_tpu_torch.ops import update_math as um

from test_cuda_fused_update import OBS, _sum_inputs, _uncollapsed_inputs

N = 100_003


def _check_bf16(kernel, plain, args, mode, what):
    """The bf16 kernel against its plain versions; returns each output's
    (error against plain bf16, bf16 - f32 gap, error against float64
    products of the same rounded operands)."""
    got, again = kernel(*args, mode), kernel(*args, mode)
    p16, p32 = plain(*args, mode), plain(*args)
    p64 = plain(*args, mode, torch.float64)
    torch.cuda.synchronize()
    errs = []
    for i, (k, k2, b, f, w) in enumerate(zip(got, again, p16, p32, p64)):
        assert torch.equal(k, k2), f"{what} output {i}: two launches differ"
        err = float((k - b).abs().max())
        gap = float((b - f).abs().max())
        e64 = float((k.double() - w).abs().max())
        scale = float(w.abs().max())
        print(f"{what} output {i}: kernel - plain bf16 {err:.3e}, bf16 - "
              f"f32 gap {gap:.3e}, kernel - float64 of the rounded "
              f"operands {e64:.3e} ({e64 / (scale + 1e-30):.2e} of max)")
        if gap > 0.0:
            assert err <= 0.25 * gap, (f"{what} output {i}: {err} > 1/4 of "
                                       f"the gap {gap}")
        else:
            assert err <= 1e-4 * float(b.abs().max()) + 1e-6, (what, i, err)
        errs.append((err, gap, e64))
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tiled", "staged"])
def test_affine_bf16_matches_plain(cuda, mode):
    """The affine actor's two roundings at obs 12, 22 and 34, and the
    launch counter counting each launch."""
    for f in (OBS, 22, 34):
        actor_in, _ = _sum_inputs(N, f, 50, cuda)
        before = fu.actor_grad_sums.launches
        _check_bf16(fu.actor_grad_sums, um.actor_grad_sums_reference,
                    (*actor_in, 0.2, 0.001), mode, f"affine {mode} F {f}")
        assert fu.actor_grad_sums.launches - before == 2


@pytest.mark.cuda
def test_affine_bf16_variants_differ(cuda):
    """The tiled and staged kernels give different sums on the same
    inputs, each other than the float32 kernel's."""
    actor_in, _ = _sum_inputs(N, OBS, 50, cuda)
    sums = {m: fu.actor_grad_sums(*actor_in, 0.2, 0.001, m)
            for m in (None, "tiled", "staged")}
    for out in (1, 2):
        assert not torch.equal(sums["tiled"][out], sums["staged"][out])
        assert not torch.equal(sums["tiled"][out], sums[None][out])


@pytest.mark.cuda
def test_critic_bf16_matches_plain(cuda):
    """The critic's bf16 instances: In 36 / H 50, 66 / 50, 102 / 50, 36 /
    128 and 36 / 256 (A = 3)."""
    for f, h in ((OBS, 50), (22, 50), (34, 50), (OBS, 128), (OBS, 256)):
        _, critic_in = _sum_inputs(N, f, h, cuda)
        before = fu.critic_grad_sums.launches
        _check_bf16(fu.critic_grad_sums, um.critic_grad_sums_reference,
                    (*critic_in, 0.2), True, f"critic In {3 * f} H {h}")
        assert fu.critic_grad_sums.launches - before == 2


@pytest.mark.cuda
def test_uncollapsed_bf16_matches_plain(cuda):
    """The un-collapsed actor's bf16 instances: F 12 / H 50, 22 / 50, 34 /
    50, 12 / 128 and 12 / 256."""
    for f, h in ((OBS, 50), (22, 50), (34, 50), (OBS, 128), (OBS, 256)):
        _check_bf16(fu.actor_grad_uncollapsed_sums,
                    um.actor_grad_sums_uncollapsed_reference,
                    (*_uncollapsed_inputs(N, f, h, cuda), 0.2, 0.001), True,
                    f"un-collapsed F {f} H {h}")


@pytest.mark.cuda
def test_bf16_without_an_instance_raises(cuda):
    """Widths the float32 kernels take but no bf16 instance does (hidden
    64; -no 14 at -hs 256: critic In 102, actor F 34 with hidden 256) raise
    ValueError in bf16 mode, and never fall back."""
    for f, h in ((OBS, 64), (34, 256)):
        _, critic_in = _sum_inputs(64, f, h, cuda)
        fu.critic_grad_sums(*critic_in, 0.2)
        with pytest.raises(ValueError, match="bf16"):
            fu.critic_grad_sums(*critic_in, 0.2, True)
        args = _uncollapsed_inputs(64, f, h, cuda)
        fu.actor_grad_uncollapsed_sums(*args, 0.2, 0.001)
        with pytest.raises(ValueError, match="bf16"):
            fu.actor_grad_uncollapsed_sums(*args, 0.2, 0.001, True)
