"""PPO update gradients through two CUDA kernels (``--fused-updates``).

Port of ``marlnav_tpu/ops/fused_update.py`` and ``fused_update_tiled.py``.
Each kernel (``ops/csrc/fused_update.cu``) computes one loss and all its
parameter-gradient sums in one streaming pass over a ``Buffer`` time slice;
the optimizer stays outside, as in the JAX package: the caller hands the
gradients to the same ``torch.optim.Adam`` the autograd route uses.

* ``actor_grad_sums`` replaces the affine actor kernels (the full-batch
  ``make_tiled_actor_grad`` and the staged ``_make_actor_grad_affine``):
  the actor has no hidden activation (reference models.py:29), so obs ->
  head pre-activations is the affine operator ``z = a_comp x + c_comp``
  (``ops.fused_collect._affine_compose``); the kernel accumulates ``Σ g_z
  xᵀ`` and ``Σ g_z``, and ``affine_recompose`` rebuilds the five true
  gradients outside.
* ``critic_grad_sums`` replaces ``make_tiled_critic_grad`` and the staged
  ``make_fused_critic_grad``: the clipped-value loss through ``In -> H ReLU
  -> 1`` and ``dW1, db1, dW2, db2``.
* ``actor_grad_uncollapsed_sums`` replaces the staged actor kernels of the
  "packed" (``make_fused_actor_grad``) and "undilated"
  (``_make_actor_grad_undilated``) layouts: the actor loss through the
  network itself, ``F -> H -> 2 + 2``, and its five gradients directly, no
  recomposition.  ``train.uncollapsed_actor`` says when it runs.

The last two share one kernel body with a head for each (critic: ReLU and
the value; actor: the 2 + 2 heads and the PPO chain), whose products run on
the tensor cores in 3xTF32 (``ops/csrc/mma_tf32.cuh``), in template
instances for critic In <= 103 and H <= 256 and un-collapsed actor F <= 39
and H <= 256 (bf16: ten of those widths).  Every other width takes the
run-time-width route (``fused_update.cu rt_forward_kernel``), which the
wrapper picks by width before the launch: the same tensor-core products
with K and H at run time, W1 streamed through shared memory a tile at a
time, three launches (forward, backward, the fixed-order reduction), or
for the critic two, one pass over the rows, where one block holds all of
H <= 64 and In <= 128 (``marlnav_rt_one_pass``; the same bits); one
count.  It raises ``ValueError`` only past its grid (over 4 million
hidden units or 8 million input columns) or 32-bit output indices.  The
affine actor takes any F <= 1023 (a runtime width: its rows stream
through shared memory in tiles sized by F; past 1023 its column groups of
[x | 1] would outnumber a block's threads).

The TPU needed two layouts of each (tiled and staged); here the Buffer's
time slice is already a contiguous block of rows, so one kernel serves the
full batch and every minibatch slice, in faithful, fixed and GAE modes.

``--bf16-updates`` (each wrapper's ``bf16``) rounds the products'
operands to bf16 where the JAX kernel of the route does
(``ops/update_math.py``); the affine actor takes the route's rounding
("tiled" or "staged"), the tensor-core kernels one bf16 ``mma.sync`` pass
a product in place of the three TF32 ones.

Routing, with no fallback: CPU tensors run the plain versions of
``ops/update_math.py``; CUDA tensors launch the kernel or raise (in bf16
mode, the kernel's bf16 variant).  Each wrapper counts its launches in
``.launches``; ``critic_grad_sums.pipelined_launches`` counts those of
them that took the critic kernel's warp-specialised body (the float32
instances of at most 64 hidden units and 39 input columns whose warps each
hold every output tile: the default and curriculum critic, In 36 / H 50),
and ``critic_grad_sums.rt_launches`` and
``actor_grad_uncollapsed_sums.rt_launches`` those that took the
run-time-width route (the critic from 15 obstacles on, In 108 and up),
their ``rt_one_pass_launches`` those of them that took it in one pass
(among them the critic from 15 to 18 obstacles at H 50; the actor's
route always takes three launches).

Data parallelism (marlnav_tpu/ops/fused_update.py:544-548,
fused_update_tiled.py:244-245, 369-370): each wrapper's ``mesh`` sums the
kernel's flat vector of sums, the loss with it, over the data group in
one all-reduce before it is cut into the gradients, and the minibatch
functions scale by the global row count, ``n_local * num_data``.  At one
rank this is the run without a mesh bit for bit.  The kernels take whole
weights: under tensor parallelism ``algo.mappo`` gathers them first and
cuts the gradients to each rank's shards after.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from marlnav_tpu_torch.ops.fused_collect import _affine_compose, _check
from marlnav_tpu_torch.ops.update_math import (
    AFFINE_BF16,
    actor_grad_sums_reference,
    actor_grad_sums_uncollapsed_reference,
    affine_recompose,
    critic_grad_sums_reference,
)


@functools.lru_cache(maxsize=None)
def _library():
    from marlnav_tpu_torch.ops._build import load_library

    lib, _ = load_library("fused_update")
    # Every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and cuts the pointer.
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.marlnav_actor_grad_sums.argtypes = (
        [ptr] * 6 + [ctypes.c_longlong, i32] + [f32] * 4
        + [i32, i32, ptr, ptr, ptr, i32, ptr])
    lib.marlnav_critic_grad_sums.argtypes = (
        [ptr] * 7 + [ctypes.c_longlong, i32, i32, f32, i32, i32, ptr, ptr,
                     i32, ptr])
    lib.marlnav_actor_grad_uncollapsed_sums.argtypes = (
        [ptr] * 10 + [ctypes.c_longlong, i32, i32] + [f32] * 4
        + [i32, i32, ptr, ptr, i32, ptr])
    lib.marlnav_rt_grad_sums.argtypes = (
        [i32] + [ptr] * 10 + [ctypes.c_longlong, i32, i32] + [f32] * 5
        + [i32, i32, i32, i32, ptr, ptr, ptr, i32, ptr])
    for fn in (lib.marlnav_actor_grad_sums, lib.marlnav_critic_grad_sums,
               lib.marlnav_actor_grad_uncollapsed_sums,
               lib.marlnav_rt_grad_sums):
        fn.restype = i32
    lib.marlnav_rt_row_blocks.argtypes = [ctypes.c_longlong, i32, i32, i32]
    lib.marlnav_rt_row_blocks.restype = i32
    lib.marlnav_rt_one_pass.argtypes = [i32, i32, i32]
    lib.marlnav_rt_one_pass.restype = i32
    for getter in (lib.marlnav_actor_max_obs, lib.marlnav_critic_max_in,
                   lib.marlnav_uncollapsed_max_obs, lib.marlnav_max_hidden):
        getter.argtypes, getter.restype = [], i32
    for shape in (lib.marlnav_critic_warps, lib.marlnav_uncollapsed_warps,
                  lib.marlnav_critic_pipelined):
        shape.argtypes, shape.restype = [i32, i32, i32], i32
    lib.marlnav_actor_tile_rows.argtypes = [i32]
    lib.marlnav_actor_tile_rows.restype = i32
    lib.marlnav_actor_resident_blocks.argtypes = [i32, i32, i32]
    lib.marlnav_actor_resident_blocks.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _actor_resident_blocks(index: int, obs_size: int, mode: int) -> int:
    """The affine actor kernel's grid at most: the blocks of its rounding
    ``mode`` (0 float32, 1 + ``AFFINE_BF16.index``) resident on card
    ``index`` at once at this obs width (the occupancy of its tile)."""
    lib = _library()
    blocks = lib.marlnav_actor_resident_blocks(obs_size, index, mode)
    if blocks == 0:
        raise ValueError(f"actor grad kernel takes obs widths "
                         f"1..{lib.marlnav_actor_max_obs()}, got {obs_size}")
    if blocks < 0:
        raise RuntimeError("actor grad kernel: occupancy query failed")
    return blocks


def _split(sums: torch.Tensor, shapes, mesh=None) -> Tuple[torch.Tensor, ...]:
    """Cut the kernel's flat vector of sums into views of these shapes,
    after summing it over ``mesh``'s ranks (in place) where one is
    given."""
    if mesh is not None:
        from marlnav_tpu_torch.parallel.sharding import all_reduce_sum

        all_reduce_sum(sums, mesh)
    out, start = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(sums[start:start + n].view(shape))
        start += n
    return tuple(out)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _launch_setup(device: torch.device, n_rows: int, rows_per_block: int):
    """(grid blocks, device index, stream) for a launch over ``n_rows``
    rows: at most one persistent block an SM, so the grid, and with it
    every sum's order, depends only on the rows and the card."""
    index = _device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    blocks = min(math.ceil(n_rows / rows_per_block), sms)
    return blocks, index, torch.cuda.current_stream(device).cuda_stream


def _rt_grad_sums(lib, actor: bool, obs, rows, w1, b1, head, n_in: int,
                  hidden: int, eps: float, ppo, bf16: bool, n_out: int,
                  one_pass: bool):
    """The run-time-width route of the critic (``actor`` False) or the
    un-collapsed actor on the current stream: in one pass over the rows
    (the gradient, then the fixed-order reduction of the row blocks'
    partials) where ``one_pass``, which the wrappers take from
    ``marlnav_rt_one_pass`` (the library refuses it elsewhere), else its
    three launches (forward, backward, the reduction); both give the same
    bits.  Returns the flat sums.  Raises ``ValueError`` where the widths
    pass its backward grid (65,535 hidden chunks of 64 units or In chunks
    of 128 columns) or a 32-bit output index."""
    n = obs.shape[0]
    index = _device_index(obs.device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    blocks = lib.marlnav_rt_row_blocks(n, n_in, hidden, sms)
    if not blocks:
        raise ValueError(
            f"{'un-collapsed actor' if actor else 'critic'} grad kernel: "
            f"input width {n_in} and hidden {hidden} pass the run-time "
            f"route's grid (65,535 chunks of 64 hidden units or of 128 "
            f"input columns) or 32-bit output indices")
    # Each row's loss term and g, from the forward to the backward.
    rowbuf = None if one_pass else torch.empty(
        n * (5 if actor else 2), dtype=torch.float32, device=obs.device)
    partials = torch.empty((blocks, n_out), dtype=torch.float32,
                           device=obs.device)
    out = torch.empty(n_out, dtype=torch.float32, device=obs.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.marlnav_rt_grad_sums(
        int(actor), obs.data_ptr(), *(ptr(x) for x in rows), w1.data_ptr(),
        b1.data_ptr(), *(ptr(x) for x in head), n, n_in, hidden, eps, *ppo,
        int(bf16), int(one_pass), sms, blocks, ptr(rowbuf),
        partials.data_ptr(), out.data_ptr(), index,
        torch.cuda.current_stream(obs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"run-time-width grad kernels launch failed: "
                           f"CUDA error {err}")
    return out


def _reduced_reference(sums, shapes, mesh):
    """A plain version's sums, summed over ``mesh``'s ranks through one
    flat vector as the kernels' are; unchanged without a mesh."""
    if mesh is None:
        return sums
    return _split(torch.cat([x.reshape(-1) for x in sums]), shapes, mesh)


def _check_rows(device, n_rows, named):
    if device.type != "cuda":
        raise ValueError(f"fused update: unsupported device {device}")
    if n_rows < 1:
        raise ValueError("fused update: no rows")
    for name, x, shape in named:
        _check(name, x, shape, torch.float32, device)


def actor_grad_sums(a_comp, c_comp, obs, actions, log_probs, adv,
                    eps: float, ent_c: float, bf16=None, mesh=None):
    """``(loss_sum (), Σ g_z xᵀ (4, F), Σ g_z (4,))`` of the PPO actor
    objective over all rows (``update_math.actor_grad_sums_reference``).
    obs (N, F), actions (N, 2), log_probs and adv (N,).  ``bf16``: None,
    or the route's rounding, "tiled" or "staged".  ``mesh``: the sums over
    every data index's rows."""
    if bf16 not in (None, *AFFINE_BF16):
        raise ValueError(f"affine actor: bf16 rounding {bf16!r} not in "
                         f"{AFFINE_BF16}")
    n, f = obs.shape
    shapes = ((), (4, f), (4,))
    if obs.device.type == "cpu":
        return _reduced_reference(actor_grad_sums_reference(
            a_comp, c_comp, obs, actions, log_probs, adv, eps, ent_c, bf16),
            shapes, mesh)
    _check_rows(obs.device, n, (
        ("a_comp", a_comp, (4, f)), ("c_comp", c_comp, (4,)),
        ("obs", obs, (n, f)), ("actions", actions, (n, 2)),
        ("log_probs", log_probs, (n,)), ("adv", adv, (n,))))
    index = _device_index(obs.device)
    mode = 0 if bf16 is None else 1 + AFFINE_BF16.index(bf16)
    capacity = _actor_resident_blocks(index, f, mode)
    n_out = 1 + 4 * f + 4
    # out, the blocks' partials (capacity, n_out) and the word where this
    # launch's blocks count themselves done, in one allocation.
    scratch = torch.empty((capacity + 1) * n_out + 1, dtype=torch.float32,
                          device=obs.device)
    out = scratch.data_ptr()
    err = _library().marlnav_actor_grad_sums(
        obs.data_ptr(), actions.data_ptr(), log_probs.data_ptr(),
        adv.data_ptr(), a_comp.data_ptr(), c_comp.data_ptr(), n, f,
        1.0 - eps, 1.0 + eps, ent_c, ent_c * 0.5, mode, capacity,
        out + 4 * n_out,
        out, out + 4 * (capacity + 1) * n_out, index,
        torch.cuda.current_stream(obs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"actor grad kernel launch failed: CUDA error {err}")
    actor_grad_sums.launches += 1
    return _split(scratch[:n_out], shapes, mesh)


actor_grad_sums.launches = 0


def critic_grad_sums(w1, b1, w2, b2, obs, vold, ret, eps: float,
                     bf16: bool = False, mesh=None):
    """``(loss_sum (), dW1 (H, In), db1 (H,), dW2 (1, H), db2 (1,))`` of
    the clipped-value loss over all rows
    (``update_math.critic_grad_sums_reference``).  obs (N, In), vold and
    ret (N,); weights in ``nn.Linear`` layout.  ``mesh``: the sums over
    every data index's rows."""
    n, n_in = obs.shape
    h = w1.shape[0]
    shapes = ((), (h, n_in), (h,), (1, h), (1,))
    if obs.device.type == "cpu":
        return _reduced_reference(critic_grad_sums_reference(
            w1, b1, w2, b2, obs, vold, ret, eps, bf16), shapes, mesh)
    _check_rows(obs.device, n, (
        ("w1", w1, (h, n_in)), ("b1", b1, (h,)), ("w2", w2, (1, h)),
        ("b2", b2, (1,)), ("obs", obs, (n, n_in)), ("vold", vold, (n,)),
        ("ret", ret, (n,))))
    lib = _library()
    n_out = 1 + h * n_in + 2 * h + 1
    # chunks of 16 rows a block takes a round; 0: no instance at these widths
    warps = lib.marlnav_critic_warps(n_in, h, int(bf16))
    if not warps:
        one_pass = bool(lib.marlnav_rt_one_pass(0, n_in, h))
        out = _rt_grad_sums(lib, False, obs, (vold, ret, None), w1, b1,
                            (w2, b2, None, None), n_in, h, eps, (0.0,) * 4,
                            bf16, n_out, one_pass)
        critic_grad_sums.launches += 1
        critic_grad_sums.rt_launches += 1
        critic_grad_sums.rt_one_pass_launches += one_pass
        return _split(out, shapes, mesh)
    blocks, index, stream = _launch_setup(obs.device, n, 16 * warps)
    partials = torch.empty((blocks, n_out), dtype=torch.float32,
                           device=obs.device)
    out = torch.empty(n_out, dtype=torch.float32, device=obs.device)
    err = lib.marlnav_critic_grad_sums(
        obs.data_ptr(), vold.data_ptr(), ret.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), n, n_in, h, eps,
        int(bf16), blocks, partials.data_ptr(), out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"critic grad kernel launch failed: CUDA error "
                           f"{err}")
    critic_grad_sums.launches += 1
    if lib.marlnav_critic_pipelined(n_in, h, int(bf16)):
        critic_grad_sums.pipelined_launches += 1
    return _split(out, shapes, mesh)


critic_grad_sums.launches = 0
critic_grad_sums.pipelined_launches = 0
critic_grad_sums.rt_launches = 0
critic_grad_sums.rt_one_pass_launches = 0


def actor_grad_uncollapsed_sums(w1, b1, wmu, bmu, wvar, bvar, obs, actions,
                                log_probs, adv, eps: float, ent_c: float,
                                bf16: bool = False, mesh=None):
    """``(loss_sum, dW1 (H, F), db1 (H,), dWmu (2, H), dbmu (2,), dWvar
    (2, H), dbvar (2,))`` of the PPO actor objective through the network
    itself over all rows
    (``update_math.actor_grad_sums_uncollapsed_reference``).  obs (N, F),
    actions (N, 2), log_probs and adv (N,); weights in ``nn.Linear``
    layout.  ``mesh``: the sums over every data index's rows."""
    n, f = obs.shape
    h = w1.shape[0]
    shapes = ((), (h, f), (h,), (2, h), (2,), (2, h), (2,))
    if obs.device.type == "cpu":
        return _reduced_reference(actor_grad_sums_uncollapsed_reference(
            w1, b1, wmu, bmu, wvar, bvar, obs, actions, log_probs, adv, eps,
            ent_c, bf16), shapes, mesh)
    _check_rows(obs.device, n, (
        ("w1", w1, (h, f)), ("b1", b1, (h,)), ("wmu", wmu, (2, h)),
        ("bmu", bmu, (2,)), ("wvar", wvar, (2, h)), ("bvar", bvar, (2,)),
        ("obs", obs, (n, f)), ("actions", actions, (n, 2)),
        ("log_probs", log_probs, (n,)), ("adv", adv, (n,))))
    lib = _library()
    n_out = 1 + h * f + 5 * h + 4
    # 16 rows a warp at a time; 0: no instance at these widths
    warps = lib.marlnav_uncollapsed_warps(f, h, int(bf16))
    if not warps:
        one_pass = bool(lib.marlnav_rt_one_pass(1, f, h))
        out = _rt_grad_sums(lib, True, obs, (actions, log_probs, adv), w1, b1,
                            (wmu, bmu, wvar, bvar), f, h, 0.0,
                            (1.0 - eps, 1.0 + eps, ent_c, ent_c * 0.5), bf16,
                            n_out, one_pass)
        actor_grad_uncollapsed_sums.launches += 1
        actor_grad_uncollapsed_sums.rt_launches += 1
        actor_grad_uncollapsed_sums.rt_one_pass_launches += one_pass
        return _split(out, shapes, mesh)
    blocks, index, stream = _launch_setup(obs.device, n, 16 * warps)
    partials = torch.empty((blocks, n_out), dtype=torch.float32,
                           device=obs.device)
    out = torch.empty(n_out, dtype=torch.float32, device=obs.device)
    err = lib.marlnav_actor_grad_uncollapsed_sums(
        obs.data_ptr(), actions.data_ptr(), log_probs.data_ptr(),
        adv.data_ptr(), w1.data_ptr(), b1.data_ptr(), wmu.data_ptr(),
        bmu.data_ptr(), wvar.data_ptr(), bvar.data_ptr(), n, f, h, 1.0 - eps,
        1.0 + eps, ent_c, ent_c * 0.5, int(bf16), blocks,
        partials.data_ptr(), out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"un-collapsed actor grad kernel launch failed: "
                           f"CUDA error {err}")
    actor_grad_uncollapsed_sums.launches += 1
    return _split(out, shapes, mesh)


actor_grad_uncollapsed_sums.launches = 0
actor_grad_uncollapsed_sums.rt_launches = 0
actor_grad_uncollapsed_sums.rt_one_pass_launches = 0


# ----------------------------------------------------------------------
# Loss and gradients of a minibatch (the JAX package's grad(params, ...))
# ----------------------------------------------------------------------

def _num_data(mesh) -> int:
    return 1 if mesh is None else mesh.num_data


@torch.no_grad()
def actor_grad(actor, mb, adv: torch.Tensor, cfg, tiled: bool = False,
               mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean actor loss of a ``Buffer`` slice ``mb`` and its gradients
    keyed as ``actor.named_parameters()``; ``adv`` (N,) holds the slice's
    per-agent advantages in its (t, p, a) row order
    (``algo.mappo.minibatch_advantages``).  With ``cfg.bf16_updates`` the
    sums round as the JAX package's tiled kernel where ``tiled`` (its
    full-batch route with the fused collect), else as its staged one.
    With a ``mesh``: the mean over every data index's slice."""
    n = adv.shape[0]
    a_comp, c_comp = _affine_compose(actor)
    bf16 = ("tiled" if tiled else "staged") if cfg.bf16_updates else None
    loss, dz, dzs = actor_grad_sums(
        a_comp, c_comp, mb.obs.reshape(n, -1), mb.actions.reshape(n, -1),
        mb.log_probs.reshape(n), adv, cfg.epsilon, cfg.ent_const, bf16, mesh)
    grads = affine_recompose(actor, dz, dzs)
    inv_n = 1.0 / (n * _num_data(mesh))
    return loss * inv_n, {k: g * inv_n for k, g in grads.items()}


@torch.no_grad()
def actor_grad_uncollapsed(actor, mb, adv: torch.Tensor, cfg, mesh=None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``actor_grad`` through the network itself instead of its affine
    operator: the counterpart of the JAX package's "packed" and
    "undilated" actor layouts (``MARLNAV_ACTOR_LAYOUT``)."""
    n = adv.shape[0]
    # parameters(): fc1, fc_mu, fc_var, each weight then bias, the order
    # the kernel takes them and returns their gradients in.
    loss, *grads = actor_grad_uncollapsed_sums(
        *(p.detach() for p in actor.parameters()), mb.obs.reshape(n, -1),
        mb.actions.reshape(n, -1), mb.log_probs.reshape(n), adv, cfg.epsilon,
        cfg.ent_const, cfg.bf16_updates, mesh)
    inv_n = 1.0 / (n * _num_data(mesh))
    return loss * inv_n, {name: g * inv_n for (name, _), g in
                          zip(actor.named_parameters(), grads)}


@torch.no_grad()
def critic_grad(critic, mb, cfg, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean clipped-value loss of a ``Buffer`` slice ``mb`` and its
    gradients keyed as ``critic.named_parameters()`` (with a ``mesh``, over
    every data index's slice)."""
    n = mb.returns.numel()
    loss, dw1, db1, dw2, db2 = critic_grad_sums(
        critic.fc1.weight, critic.fc1.bias, critic.fc2.weight,
        critic.fc2.bias, mb.obs.reshape(n, -1), mb.values.reshape(n),
        mb.returns.reshape(n), cfg.epsilon, cfg.bf16_updates, mesh)
    inv_n = 1.0 / (n * _num_data(mesh))
    grads = {"fc1.weight": dw1, "fc1.bias": db1, "fc2.weight": dw2,
             "fc2.bias": db2}
    return loss * inv_n, {k: g * inv_n for k, g in grads.items()}
