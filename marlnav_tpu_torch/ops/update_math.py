"""The PPO update gradients of the fused-update kernels, as plain PyTorch.

Port of the elementwise chains of ``marlnav_tpu/ops/fused_update.py``
(``_balanced_sel`` :336, ``_ppo_chain`` :345, ``_critic_chain`` :403,
``_affine_recompose`` :689), on flat row tensors instead of the TPU's
sublane-packed tiles.  Each follows its source op for op: JAX's balanced
min/max tie (both branches get half the gradient on an exact tie), the clip
derivative 1 inside the band, 1/2 on an exact bound and 0 outside, softplus
and sigmoid sharing one ``exp(-|s|)``, and ``relu'(0) = 0``.

These are hand-derived backwards, not autograd: they are what the CUDA
kernels of ``ops/csrc/fused_update.cu`` compute, and the plain versions
those kernels are held against.  ``actor_grad_sums_reference`` (through
the affine operator), ``actor_grad_sums_uncollapsed_reference`` (through
the 12 -> 50 -> 2+2 network itself) and ``critic_grad_sums_reference``
return sums over all rows; the caller divides by the row count.  They run in the dtype of their inputs, so a
float64 call gives the reference that sum-order noise is measured against.

``--bf16-updates`` (``bf16``): each round the operands of its products to
bf16 (round to nearest, ties to even) where the JAX kernel it stands for
does (``_dot(..., dtype)``, marlnav_tpu/ops/fused_update.py:429), products
summed in float32; biases, bias sums and the chains stay float32.  The
JAX package rounds differently on each route, so the affine actor takes
the route: ``"tiled"`` (``make_tiled_actor_grad``,
fused_update_tiled.py:199-204: the forward unrounded, ``g_z`` and ``x``
rounded in ``Σ g_z xᵀ``, ``Σ g_z`` of the rounded ``g_z``) or
``"staged"`` (``_make_actor_grad_affine``, fused_update.py:734-741: ``a_comp``
and ``x`` rounded in the forward too, ``Σ g_z`` of the float32 ``g_z``).
``acc`` (default: the inputs' dtype) is the dtype the products and the
row sums are taken in: float64 with bf16 on gives the kernels' products of
the same rounded operands without their float32 accumulation.

Rows: an actor row is one (step, env, agent), in the ``Buffer``'s flat
(t, p, a) order (``obs.reshape(-1, F)``, ``log_probs.reshape(-1)``); a
critic row is one (step, env) with the agents' observations side by side
(``obs.reshape(-1, A * F)``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def balanced_sel(a: torch.Tensor, b: torch.Tensor):
    """JAX's min/max tie rule: (weight on the a-branch, weight on the
    b-branch) of ``min(a, b)``; swap the pair for ``max``."""
    lt = (a < b).to(a.dtype)
    eq = (a == b).to(a.dtype)
    wa = lt + 0.5 * eq
    return wa, 1.0 - wa


def _clip_grad(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """d clip(x, lo, hi) / dx under JAX's balanced ties: 1 inside, 0
    outside, 1/2 exactly on a bound."""
    inside = (x > lo).to(x.dtype) * (x < hi).to(x.dtype)
    on_edge = (x == lo).to(x.dtype) + (x == hi).to(x.dtype)
    return inside + 0.5 * on_edge


def ppo_chain(u, s, act, lp_b, adv, eps: float, ent_c: float):
    """The actor objective from the head pre-activations, and its backward.

    u, s, act: (N, 2) mean pre-activation, variance pre-activation and the
    behaviour action; lp_b, adv: (N,).  Returns ``(loss_rows (N,), g_u,
    g_s)``: each row's term of the negated PPO-clip + entropy objective
    and its gradient with respect to u and s."""
    mu = torch.tanh(u)
    # softplus(s) = max(s, 0) + log1p(e) and sigmoid(s) = {1, e} / (1 + e)
    # for s {>=, <} 0 share e = exp(-|s|).
    e_s = torch.exp(-torch.abs(s))
    var = torch.clamp_min(s, 0.0) + torch.log1p(e_s)

    diff = act - mu
    inv_var = 1.0 / var
    log_var = torch.log(var)
    zz = diff * diff * inv_var
    lv_sum = log_var[:, 0] + log_var[:, 1]
    lp_new = -0.5 * (2.0 * _LOG_2PI + lv_sum + zz[:, 0] + zz[:, 1])
    ent = (1.0 + _LOG_2PI) + 0.5 * lv_sum

    ratio = torch.exp(lp_new - lp_b)
    lo, hi = 1.0 - eps, 1.0 + eps
    clipped = torch.clamp_max(torch.clamp_min(ratio, lo), hi)
    o1 = ratio * adv
    o2 = clipped * adv
    obj = torch.minimum(o1, o2)
    loss_rows = -(obj + ent_c * ent)

    w_o1, w_o2 = balanced_sel(o1, o2)
    dclip = _clip_grad(ratio, lo, hi)
    g_ratio = -adv * (w_o1 + w_o2 * dclip)
    g_lp = (g_ratio * ratio)[:, None]
    g_mu = g_lp * diff * inv_var
    g_var = g_lp * 0.5 * (zz - 1.0) * inv_var - (ent_c * 0.5) * inv_var
    g_u = g_mu * (1.0 - mu * mu)
    r_e = 1.0 / (1.0 + e_s)
    g_s = g_var * torch.where(s >= 0.0, r_e, e_s * r_e)
    return loss_rows, g_u, g_s


def critic_chain(v, vold, ret, eps: float):
    """The clipped-value loss from the new values, and its backward
    (reference models.py:301-316).  All (N,).  Returns ``(loss_rows,
    g_v)``."""
    lo, hi = vold - eps, vold + eps
    clamped = torch.minimum(torch.maximum(v, lo), hi)
    e1 = v - ret
    e2 = clamped - ret
    d1 = e1 * e1
    d2 = e2 * e2
    loss_rows = torch.maximum(d1, d2)
    w_d2, w_d1 = balanced_sel(d1, d2)  # max: the weight goes to the larger
    g_v = 2.0 * (w_d1 * e1 + w_d2 * e2 * _clip_grad(v, lo, hi))
    return loss_rows, g_v


# The affine actor's bf16 roundings, by the JAX route each stands for.
AFFINE_BF16 = ("tiled", "staged")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), kept in ``x``'s
    dtype: JAX's ``astype(jnp.bfloat16)`` of a matmul operand."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mm(a, b, bf16: bool, acc):
    """``a @ b``, its operands rounded to bf16 where ``bf16``, its products
    summed in ``acc`` (default: the operands' dtype)."""
    if bf16:
        a, b = round_bf16(a), round_bf16(b)
    return a @ b if acc is None else a.to(acc) @ b.to(acc)


def _row_sum(x, acc):
    """``x`` summed over its rows (dim 0), in ``acc``."""
    return x.sum(0) if acc is None else x.to(acc).sum(0)


def actor_grad_sums_reference(a_comp, c_comp, obs, actions, log_probs, adv,
                              eps: float, ent_c: float, bf16=None, acc=None):
    """The actor kernel's function: over all rows, ``(loss_sum, Σ g_z xᵀ
    (4, F), Σ g_z (4,))`` through the affine operator ``z = a_comp x +
    c_comp`` (rows 0-1 of z are the mean pre-activations, 2-3 the
    variance ones).  obs (N, F), actions (N, 2), log_probs and adv (N,).
    ``bf16``: None, or the route's rounding, "tiled" or "staged"."""
    if bf16 not in (None, *AFFINE_BF16):
        raise ValueError(f"affine actor: bf16 rounding {bf16!r} not in "
                         f"{AFFINE_BF16}")
    z = _mm(obs, a_comp.T, bf16 == "staged", acc).to(obs.dtype) + c_comp
    loss_rows, g_u, g_s = ppo_chain(z[:, :2], z[:, 2:], actions, log_probs,
                                    adv, eps, ent_c)
    g_z = torch.cat([g_u, g_s], dim=1)  # (N, 4)
    g_sum = round_bf16(g_z) if bf16 == "tiled" else g_z
    return (_row_sum(loss_rows, acc), _mm(g_z.T, obs, bf16 is not None, acc),
            _row_sum(g_sum, acc))


def actor_grad_sums_uncollapsed_reference(w1, b1, wmu, bmu, wvar, bvar, obs,
                                          actions, log_probs, adv,
                                          eps: float, ent_c: float,
                                          bf16: bool = False, acc=None):
    """The un-collapsed actor kernel's function: over all rows, the PPO
    actor objective through the network itself, ``h = W1 x + b1`` (no
    hidden activation), ``u = Wmu h + bmu``, ``s = Wvar h + bvar``
    (marlnav_tpu/ops/fused_update.py:471-490, 573-600), and its backward
    ``g_h = Wmuᵀ g_u + Wvarᵀ g_s``.  Weights in ``nn.Linear`` layout (w1
    (H, F), wmu and wvar (2, H)).  Returns ``(loss_sum, Σ g_h xᵀ (H, F),
    Σ g_h (H,), Σ g_u hᵀ (2, H), Σ g_u (2,), Σ g_s hᵀ (2, H), Σ g_s (2,))``:
    the five parameters' gradient sums, shaped as the parameters.  With
    ``bf16`` every product rounds its operands (marlnav_tpu/ops/
    fused_update.py:473-490, 575-600), ``h`` (float32, bias added) as an
    operand of the heads and of ``Σ g_u hᵀ``."""
    dt = obs.dtype
    h = _mm(obs, w1.T, bf16, acc).to(dt) + b1
    u = _mm(h, wmu.T, bf16, acc).to(dt) + bmu
    s = _mm(h, wvar.T, bf16, acc).to(dt) + bvar
    loss_rows, g_u, g_s = ppo_chain(u, s, actions, log_probs, adv, eps, ent_c)
    g_h = _mm(g_u, wmu, bf16, acc).to(dt) + _mm(g_s, wvar, bf16, acc).to(dt)
    return (_row_sum(loss_rows, acc), _mm(g_h.T, obs, bf16, acc),
            _row_sum(g_h, acc), _mm(g_u.T, h, bf16, acc), _row_sum(g_u, acc),
            _mm(g_s.T, h, bf16, acc), _row_sum(g_s, acc))


def critic_grad_sums_reference(w1, b1, w2, b2, obs, vold, ret, eps: float,
                               bf16: bool = False, acc=None):
    """The critic kernel's function: over all rows of the critic
    ``In -> H ReLU -> 1`` (weights in ``nn.Linear`` layout: w1 (H, In), b1
    (H,), w2 (1, H), b2 (1,)), ``(loss_sum, dW1, db1, dW2, db2)`` shaped
    as the parameters.  obs (N, In), vold and ret (N,).  With ``bf16``
    the five products round their operands (marlnav_tpu/ops/
    fused_update.py:810-824): ``W1`` and ``x``, ``w2`` and ``h``, ``w2``
    and ``g_v`` (``g_h``), ``g_v`` and ``h`` (dW2), ``g_pre`` and ``x``
    (dW1); ``db1`` and ``db2`` sum the float32 ``g_pre`` and ``g_v``."""
    dt = obs.dtype
    rnd = round_bf16 if bf16 else (lambda x: x)
    h = torch.relu(_mm(obs, w1.T, bf16, acc).to(dt) + b1)
    v = _mm(h, w2[0], bf16, acc).to(dt) + b2[0]
    loss_rows, g_v = critic_chain(v, vold, ret, eps)
    g_h = rnd(g_v)[:, None] * rnd(w2)  # one product a term: exact in bf16
    g_pre = g_h * (h > 0.0).to(h.dtype)  # relu'(0) = 0
    return (_row_sum(loss_rows, acc), _mm(g_pre.T, obs, bf16, acc),
            _row_sum(g_pre, acc), _mm(g_v, h, bf16, acc)[None, :],
            _row_sum(g_v, acc)[None])


@torch.no_grad()
def affine_recompose(actor, dz: torch.Tensor,
                     dzs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Chain-rule the operator's sums ``dz = [Σ g_u xᵀ; Σ g_s xᵀ]`` (4, F)
    and ``dzs = [Σ g_u; Σ g_s]`` (4,) back into the five parameters'
    gradients, keyed and shaped as ``actor.named_parameters()``."""
    w1, b1 = actor.fc1.weight, actor.fc1.bias  # (H, F), (H,)
    wmu, wvar = actor.fc_mu.weight, actor.fc_var.weight  # (2, H)
    guxt, gsxt = dz[:2], dz[2:]
    su, ss = dzs[:2], dzs[2:]
    return {
        "fc1.weight": wmu.T @ guxt + wvar.T @ gsxt,
        "fc1.bias": wmu.T @ su + wvar.T @ ss,
        "fc_mu.weight": guxt @ w1.T + su[:, None] * b1[None, :],
        "fc_mu.bias": su,
        "fc_var.weight": gsxt @ w1.T + ss[:, None] * b1[None, :],
        "fc_var.bias": ss,
    }

