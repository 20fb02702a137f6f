"""The MAPPO training rollout (collect) fused into one CUDA kernel.

Port of ``marlnav_tpu/ops/fused_collect.py`` (plus the ``RowState`` layout
of ``ops/fused_rollout.py``).  The kernel (``ops/csrc/fused_collect.cu``)
steps each env through all T steps on a group of ``COLLECT_LANES`` lanes
of one warp (two an agent), with the env state in registers, and writes
the training buffer — normalized observations, raw sampled actions,
per-agent log-probs, rewards, done flags and the episode counters — in
the canonical ``Buffer`` layout.  The actor runs in-kernel
as its precomposed (4, obs) affine operator (``_affine_compose``: the
reference actor has no hidden activation).

After the kernel, as in the JAX package (fused_collect.py:403-478): the
centralized critic's values from the emitted obs as one ``nn.Linear``
pass, the returns (the returns kernel, ``ops/returns.py``, in the
sequential order), and for GAE the bootstrap value of the final state.
Nothing in the collect reads the device back, so a CUDA graph can hold
it; the kernel's seed lives in device memory for that reason.

Routing, with no fallback: CPU tensors run the plain version
``collect_rows_reference`` (uniforms drawn from a generator seeded with
``seed``); CUDA tensors launch the kernel or raise.

Log-prob identity: actions are mu + sqrt(var) * z, so (a - mu)^2 / var ==
z^2 and log p(a) = -0.5 * (2*log(2*pi) + log v0 + log v1 + z0^2 + z1^2),
DiagGaussian.log_prob exactly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from marlnav_tpu_torch.algo.mappo import (
    Buffer,
    RolloutMetrics,
    discounted_returns,
    gae_advantages,
    reference_returns,
)
from marlnav_tpu_torch.config import MAPPOConfig, TriangleInitConfig
from marlnav_tpu_torch.env import geometry
from marlnav_tpu_torch.env.env import compute_observations
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.ops.step_math import StepMath, box_muller
from marlnav_tpu_torch.utils.seeding import make_generator
from marlnav_tpu_torch.utils.transforms import make_obs_normalizer

_LOG_2PI = math.log(2.0 * math.pi)


# ----------------------------------------------------------------------
# Row layout (marlnav_tpu/ops/fused_rollout.py RowState)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RowState:
    """Transposed env state, env axis last.

    px, py   (A, P) agent positions
    dx, dy   (A, P) unit headings
    sp       (A, P) speeds
    obx, oby (O, P) obstacle positions
    tg       (2, P) target position [x; y]
    misc     (2, P) [step_num; target-reach latch], both as float32
    """

    px: torch.Tensor
    py: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    sp: torch.Tensor
    obx: torch.Tensor
    oby: torch.Tensor
    tg: torch.Tensor
    misc: torch.Tensor

    def fields(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def env_state_to_rows(state: EnvState) -> RowState:
    """EnvState (P-leading) -> RowState (P-last), contiguous rows."""
    s = state.states  # (P, A, 5)
    rows = [s[:, :, k].T for k in range(5)] + [
        state.obstacles[:, :, 0].T, state.obstacles[:, :, 1].T,
        state.target[:, 0, :].T,
        torch.stack([state.step_num.to(torch.float32),
                     state.terminates.to(torch.float32)])]
    return RowState(*(r.contiguous() for r in rows))


def rows_to_env_arrays(rows: RowState):
    """RowState -> (states (P,A,5), obstacles (P,O,2), target (P,1,2),
    step_num (P,) int32, latch (P,) bool)."""
    states = torch.stack([rows.px, rows.py, rows.dx, rows.dy, rows.sp],
                         dim=-1).permute(1, 0, 2)
    obstacles = torch.stack([rows.obx, rows.oby], dim=-1).permute(1, 0, 2)
    target = rows.tg.T[:, None, :]
    return (states, obstacles, target, rows.misc[0].to(torch.int32),
            rows.misc[1] > 0.5)


def rows_to_env_state(rows: RowState, generator: torch.Generator,
                      stats: Optional[EpisodeStats] = None) -> EnvState:
    """RowState -> canonical ``EnvState`` (``stats`` default to zeros)."""
    states, obstacles, target, step_num, latch = rows_to_env_arrays(rows)
    return EnvState(
        states=states.contiguous(), obstacles=obstacles.contiguous(),
        target=target.contiguous(), step_num=step_num, terminates=latch,
        stats=stats if stats is not None else EpisodeStats.zeros(
            rows.px.device),
        generator=generator)


@torch.no_grad()
def _affine_compose(actor):
    """Precompose the activation-free actor into the (4, obs) operator
    z = a_comp x + c_comp (marlnav_tpu/ops/fused_update.py:656-686).  In
    full float32: the package turns TF32 off at import, because the whole
    trajectory is sampled through this operator."""
    w1, b1 = actor.fc1.weight, actor.fc1.bias  # (H, obs), (H,)
    heads = (actor.fc_mu, actor.fc_var)  # weight (2, H), bias (2,)
    a_comp = torch.cat([h.weight @ w1 for h in heads])  # (4, obs)
    c_comp = torch.cat([h.weight @ b1 + h.bias for h in heads])  # (4,)
    return a_comp, c_comp


# ----------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CollectOutput:
    """What the kernel (and its plain version) returns."""

    rows: RowState  # final state
    obs: torch.Tensor  # (T, P, A, F) normalized pre-step observations
    actions: torch.Tensor  # (T, P, A, 2) raw sampled actions
    log_probs: torch.Tensor  # (T, P*A)
    rewards: torch.Tensor  # (T, P)
    done: torch.Tensor  # (T, P) bool
    stats: torch.Tensor  # (3,) int32 [truncations, collisions, all-in-target]


@dataclasses.dataclass
class StepRecord:
    """One step of ``roll_rows``, as (P,) rows."""

    feats: list  # [agent][feature] normalized pre-step observations
    ang_raw: list  # [agent] raw actions
    acc_raw: list
    log_probs: Optional[list]  # [agent]; None for policy-mean actions
    reward: torch.Tensor
    finished: torch.Tensor  # 1.0 where the env truncated or terminated
    trunc: torch.Tensor
    any_coll: torch.Tensor
    all_in_target: torch.Tensor


@torch.no_grad()
def roll_rows(sm: StepMath, rows: RowState, a_comp: torch.Tensor,
              c_comp: torch.Tensor, uniforms: torch.Tensor,
              deterministic: bool, on_step) -> RowState:
    """The step loop of the collect and rollout kernels in plain PyTorch
    (ops/csrc/env_step.cuh), on the row layout; returns the final state.

    ``uniforms`` (T, n_draws, P) in [0, 1), in the kernels' draw order:
    [0, 2A) actions, then obstacle x, obstacle y, then 3 per agent for
    noisy resets.  ``deterministic`` takes the policy mean as the action
    and skips the action draws; the reset draws stay at slot 2A either way
    (marlnav_tpu/ops/fused_rollout.py:228-257).  ``on_step`` receives each
    step's ``StepRecord``."""
    a = sm.a
    wa, ca = a_comp.tolist(), c_comp.tolist()
    px, py, hx, hy, sp = (list(r.unbind(0)) for r in
                          (rows.px, rows.py, rows.dx, rows.dy, rows.sp))
    obx, oby = list(rows.obx.unbind(0)), list(rows.oby.unbind(0))
    tx, ty = rows.tg[0], rows.tg[1]
    step_num, latch = rows.misc[0], rows.misc[1]
    for u in uniforms:  # (n_draws, P) per step
        feats_all = sm.obs_feats(px, py, hx, hy, obx, oby, tx, ty)
        ang_raw, acc_raw, lp = [], [], []
        for i in range(a):
            mu, var = sm.actor_affine(feats_all[i], wa, ca,
                                      want_var=not deterministic)
            if deterministic:
                ang_raw.append(mu[0])
                acc_raw.append(mu[1])
                continue
            z0, z1 = box_muller(u[2 * i], u[2 * i + 1])
            ang_raw.append(mu[0] + torch.sqrt(var[0]) * z0)
            acc_raw.append(mu[1] + torch.sqrt(var[1]) * z1)
            lp.append(-0.5 * (2.0 * _LOG_2PI + torch.log(var[0])
                              + torch.log(var[1]) + z0 * z0 + z1 * z1))

        npx, npy, nhx, nhy, nsp = sm.dynamics(px, py, hx, hy, sp, ang_raw,
                                              acc_raw)
        step_num = step_num + 1.0
        trunc = (step_num > float(sm.p.episode_len - 1)).float()
        reward, all_in_target, any_coll = sm.rewards(
            npx, npy, nhx, nhy, obx, oby, tx, ty, px, py)
        terminated = torch.maximum(any_coll, latch)
        finished = torch.maximum(terminated, trunc)
        new_latch = torch.where(latch > 0.5, 0.0, all_in_target)
        on_step(StepRecord(feats_all, ang_raw, acc_raw,
                           None if deterministic else lp, reward, finished,
                           trunc, any_coll, all_in_target))

        (px, py, hx, hy, sp, obx, oby, step_num, latch) = sm.reset_blend(
            finished, 1.0 - finished, npx, npy, nhx, nhy, nsp, obx, oby,
            step_num, new_latch, u[2 * a:])

    return RowState(torch.stack(px), torch.stack(py), torch.stack(hx),
                    torch.stack(hy), torch.stack(sp), torch.stack(obx),
                    torch.stack(oby), rows.tg.clone(),
                    torch.stack([step_num, latch]))


@torch.no_grad()
def collect_rows_reference(sm: StepMath, rows: RowState,
                           a_comp: torch.Tensor, c_comp: torch.Tensor,
                           uniforms: torch.Tensor) -> CollectOutput:
    """The collect kernel's function in plain PyTorch: ``roll_rows`` with
    sampled actions, recording the training buffer and the counters."""
    stats = torch.zeros(3, dtype=torch.int32, device=rows.px.device)
    obs_t, act_t, lp_t, rew_t, done_t = [], [], [], [], []

    def record(s: StepRecord):
        nonlocal stats
        obs_t.append(torch.stack([torch.stack(f, -1) for f in s.feats], 1))
        act_t.append(torch.stack([torch.stack([ang, acc], -1) for ang, acc
                                  in zip(s.ang_raw, s.acc_raw)], 1))
        lp_t.append(torch.stack(s.log_probs, 1).reshape(-1))
        rew_t.append(s.reward)
        done_t.append(s.finished > 0.5)
        stats = stats + torch.stack([s.trunc.sum(), s.any_coll.sum(),
                                     s.all_in_target.sum()]).to(torch.int32)

    final = roll_rows(sm, rows, a_comp, c_comp, uniforms, False, record)
    return CollectOutput(final, torch.stack(obs_t), torch.stack(act_t),
                         torch.stack(lp_t), torch.stack(rew_t),
                         torch.stack(done_t), stats)


# ----------------------------------------------------------------------
# The CUDA kernel's wrapper
# ----------------------------------------------------------------------

class _Rows(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("px", "py", "dx", "dy", "sp", "obx", "oby", "tg", "misc")]


_INT_FIELDS = ("num_envs", "num_steps", "num_obstacles", "noisy",
               "group_soft", "wide_angle")
_FLOAT_FIELDS = (
    "trunc_after", "min_speed", "max_speed", "min_accel", "max_accel",
    "risk_factor", "distance_factor", "heading_factor", "target_factor",
    "soft_factor", "bond_factor", "group_soft_scale",
    "ob_risk_dist", "ag_risk_dist", "ob_coll_dist", "ag_coll_dist",
    "agents_min_d", "agents_max_d", "max_at_prop_d", "target_radius",
    "cap_distance", "ideal_dist", "cos_head",
    "inv_init_dist", "inv_max_at_prop_d", "inv_bond_sharpness",
    "inv_others", "inv_agents",
    "inv_pi", "d_scale", "ang_mean", "ang_scale", "acc_mean", "acc_scale")
_FLOAT_TAIL = ("pos_std", "angle_range", "init_speed", "ox_range", "oy_range",
               "ox_mean", "oy_mean", "neg_pi", "pi", "log2pi2")


class _KernelParams(ctypes.Structure):
    """Mirror of ``StepParams`` in ops/csrc/env_step.cuh."""

    _fields_ = ([(n, ctypes.c_int32) for n in _INT_FIELDS]
                + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [("base_x", ctypes.c_float * 3),
                   ("base_y", ctypes.c_float * 3)]
                + [(n, ctypes.c_float) for n in _FLOAT_TAIL])


def _kernel_params(sm: StepMath, num_envs: int,
                   num_steps: int) -> _KernelParams:
    p, icfg = sm.p, sm.init_cfg
    kp = _KernelParams()
    ints = dict(num_envs=num_envs, num_steps=num_steps, num_obstacles=sm.o,
                noisy=int(sm.noisy), group_soft=int(bool(p.group_soft_factor)),
                wide_angle=int(sm.angle_range > 2.0 * math.pi))
    floats = dict(
        trunc_after=float(p.episode_len - 1),
        group_soft_scale=p.group_soft_factor / p.init_dist,
        neg_pi=-math.pi, pi=math.pi, log2pi2=2.0 * _LOG_2PI,
        init_speed=icfg.init_speed)
    for name in _INT_FIELDS:
        setattr(kp, name, ints[name])
    for name in _FLOAT_FIELDS + _FLOAT_TAIL:
        # The rest are StepMath's derived constants or EnvParams fields.
        value = floats.get(name, getattr(sm, name, None))
        setattr(kp, name, getattr(p, name) if value is None else value)
    kp.base_x[:] = sm.base_x
    kp.base_y[:] = sm.base_y
    return kp


# Lanes of one warp that step one env together (kLanes in
# ops/csrc/fused_collect.cu; the wrapper checks the library's), and the
# threads of a block of either rollout kernel.
COLLECT_LANES = 8
BLOCK_THREADS = 128


def launch_geometry(num_envs: int, lanes: int,
                    threads: int = BLOCK_THREADS):
    """``(blocks, threads)`` of a rollout kernel's launch over ``num_envs``
    envs, ``lanes`` consecutive threads an env: env p is stepped by threads
    ``lanes * p .. lanes * p + lanes - 1`` of the grid.  ``lanes`` divides
    32 and a block is whole warps, so no env's group crosses a warp; the
    last block's groups past ``num_envs`` run along and store nothing."""
    return -(-lanes * num_envs // threads), threads


def block_threads(what: str, sm: StepMath, max_obstacles: int,
                  rt_smem) -> int:
    """Threads a block of a rollout kernel: ``BLOCK_THREADS`` for the
    templated instances (1 .. ``max_obstacles`` obstacles); for the
    run-time instance past them, the most of 128, 64 and 32 whose groups'
    observation rows, obstacles and uniforms fit one block's shared memory
    (``rt_smem(o, noisy, threads)``: its bytes, or -1).  Raises
    ``ValueError`` where not even one warp's groups fit."""
    if sm.o <= max_obstacles:
        return BLOCK_THREADS
    for threads in (BLOCK_THREADS, 64, 32):
        if rt_smem(sm.o, int(sm.noisy), threads) >= 0:
            return threads
    raise ValueError(
        f"{what} kernel: the observation rows, obstacles and uniforms of "
        f"one warp's envs at {sm.o} obstacles do not fit one block's "
        f"shared memory (232448 bytes)")


def _library():
    from marlnav_tpu_torch.ops._build import load_library

    lib, record = load_library("fused_collect")
    # Every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and cuts the pointer.
    fn = lib.marlnav_fused_collect
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.marlnav_collect_rt_smem.argtypes = [ctypes.c_int] * 3
    lib.marlnav_collect_rt_smem.restype = ctypes.c_int
    for getter in (lib.marlnav_collect_params_size,
                   lib.marlnav_collect_max_obstacles,
                   lib.marlnav_collect_lanes):
        getter.argtypes, getter.restype = [], ctypes.c_int
    if lib.marlnav_collect_params_size() != ctypes.sizeof(_KernelParams):
        raise RuntimeError("StepParams layout differs between "
                           "env_step.cuh and _KernelParams")
    if lib.marlnav_collect_lanes() != COLLECT_LANES:
        raise RuntimeError("kLanes of fused_collect.cu differs from "
                           "COLLECT_LANES")
    return lib, record


def _check(name, x: torch.Tensor, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _check_launch(sm: StepMath, rows: RowState, a_comp: torch.Tensor,
                  c_comp: torch.Tensor, num_steps: int,
                  noise: Optional[torch.Tensor]):
    """Raise unless a rollout kernel (collect or bench) can take these
    inputs: rows (r, P), the actor operator and the optional uniforms,
    float32, contiguous, on the rows' device.  Every obstacle count >= 1
    has an instance: 1 .. 8 templated, past 8 the run-time one
    (``block_threads`` checks its shared memory)."""
    device = rows.px.device
    a, o, num_envs = sm.a, sm.o, rows.px.shape[-1]
    if o < 1:
        raise ValueError(f"rollout kernels need an obstacle, got {o}")
    if num_envs < 1 or num_steps < 1:
        raise ValueError(f"need num_envs, num_steps >= 1: {num_envs}, "
                         f"{num_steps}")
    f32 = torch.float32
    for name, x, r in zip(("px", "py", "dx", "dy", "sp", "obx", "oby", "tg",
                           "misc"), rows.fields(),
                          (a, a, a, a, a, o, o, 2, 2)):
        _check(name, x, (r, num_envs), f32, device)
    _check("a_comp", a_comp, (4, sm.obs_size), f32, device)
    _check("c_comp", c_comp, (4,), f32, device)
    if noise is not None:
        _check("noise", noise, (num_steps, sm.n_draws, num_envs), f32, device)


def seed_tensor(seed, device) -> torch.Tensor:
    """The collect kernel's seed as the one int32 it reads from device
    memory: ``seed`` itself where it is such a tensor on ``device``, else a
    new one holding the low 32 bits of the int ``seed``."""
    if torch.is_tensor(seed):
        if seed.device != device or seed.dtype != torch.int32 \
                or seed.numel() != 1:
            raise ValueError(f"seed: expected one int32 on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return seed
    low = int(seed) & 0xFFFFFFFF
    # Filled on the device: no copy from the host, which would wait for it.
    return torch.full((), low - (1 << 32) if low >= 1 << 31 else low,
                      dtype=torch.int32, device=device)


def fused_collect_rows(sm: StepMath, rows: RowState, a_comp: torch.Tensor,
                       c_comp: torch.Tensor, seed, num_steps: int,
                       noise: Optional[torch.Tensor] = None
                       ) -> CollectOutput:
    """Run ``num_steps`` collect steps from ``rows``.

    ``seed`` is an int or one int32 on the rows' device.  On CUDA tensors
    this launches the kernel (random numbers from its Philox stream keyed
    on the seed, which the kernel reads from device memory, or from
    ``noise`` (T, n_draws, P) when given) and raises on anything it cannot
    launch.  On CPU tensors it runs the plain version on ``noise``, or on
    uniforms drawn from a generator seeded with ``seed``.
    ``fused_collect_rows.launches`` counts kernel launches."""
    device = rows.px.device
    a, num_envs = sm.a, rows.px.shape[-1]
    if device.type == "cpu":
        if noise is None:
            noise = torch.rand((num_steps, sm.n_draws, num_envs),
                               generator=make_generator(int(seed), "cpu"))
        return collect_rows_reference(sm, rows, a_comp, c_comp, noise)
    if device.type != "cuda":
        raise ValueError(f"fused collect: unsupported device {device}")

    lib, _ = _library()
    _check_launch(sm, rows, a_comp, c_comp, num_steps, noise)
    threads = block_threads("fused collect", sm,
                            lib.marlnav_collect_max_obstacles(),
                            lib.marlnav_collect_rt_smem)
    seed = seed_tensor(seed, device)
    f32 = torch.float32
    weights = torch.cat([a_comp.reshape(-1), c_comp])
    out_rows = RowState(*(torch.empty_like(x) for x in rows.fields()))
    t, p, f = num_steps, num_envs, sm.obs_size
    out = CollectOutput(
        out_rows,
        obs=torch.empty((t, p, a, f), dtype=f32, device=device),
        actions=torch.empty((t, p, a, 2), dtype=f32, device=device),
        log_probs=torch.empty((t, p * a), dtype=f32, device=device),
        rewards=torch.empty((t, p), dtype=f32, device=device),
        done=torch.empty((t, p), dtype=torch.bool, device=device),
        stats=torch.zeros(3, dtype=torch.int32, device=device))
    ptrs_in = _Rows(*(x.data_ptr() for x in rows.fields()))
    ptrs_out = _Rows(*(x.data_ptr() for x in out_rows.fields()))
    params = _kernel_params(sm, num_envs, num_steps)
    stream = torch.cuda.current_stream(device).cuda_stream
    blocks, threads = launch_geometry(num_envs, COLLECT_LANES, threads)
    err = lib.marlnav_fused_collect(
        ctypes.byref(ptrs_in), ctypes.byref(ptrs_out), weights.data_ptr(),
        None if noise is None else noise.data_ptr(), seed.data_ptr(),
        ctypes.byref(params),
        out.obs.data_ptr(), out.actions.data_ptr(), out.log_probs.data_ptr(),
        out.rewards.data_ptr(), out.done.data_ptr(), out.stats.data_ptr(),
        blocks, threads, device.index if device.index is not None
        else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"fused collect kernel launch failed: CUDA error "
                           f"{err}")
    fused_collect_rows.launches += 1
    return out


fused_collect_rows.launches = 0


# ----------------------------------------------------------------------
# The collect entry point
# ----------------------------------------------------------------------

def make_fused_collect(cfg: MAPPOConfig, env_params, init_cfg,
                       normalizer_cfg, scaler_cfg):
    """Build ``collect(ts, rows, seed, noise=None) -> (rows', Buffer,
    RolloutMetrics)``, the fused counterpart of ``MAPPO.collect`` on the
    RowState layout.  ``seed`` is the kernel's Philox key, an int or one
    int32 on the rows' device (``seed_tensor``); ``noise`` optionally
    injects the uniforms (T, n_draws, P)."""
    if not isinstance(init_cfg, TriangleInitConfig):
        raise NotImplementedError(
            "the fused collect covers the triangle scenario family; use "
            "the plain collect (no --fused-collect) for mock scenarios")
    sm = StepMath(env_params, init_cfg, normalizer_cfg, scaler_cfg)
    num_steps, a, f = cfg.buffer_len, sm.a, sm.obs_size

    def run_kernel(ts, rows: RowState, seed, noise=None):
        """The kernel alone (no critic / returns tail)."""
        a_comp, c_comp = _affine_compose(ts.actor)
        return fused_collect_rows(sm, rows, a_comp, c_comp, seed, num_steps,
                                  noise)

    # device -> (others' indices, obs normalizer), built at a device's
    # first collect: no copy from the host in a later (captured) one.
    obs_consts = {}

    def final_obs(rows: RowState):
        """(P, A, obs) normalized observations of the final state, for the
        GAE bootstrap value."""
        states, obstacles, target, _, _ = rows_to_env_arrays(rows)
        device = rows.px.device
        if device not in obs_consts:
            obs_consts[device] = (geometry.others_indices(a, device),
                                  make_obs_normalizer(normalizer_cfg, device))
        others, normalize = obs_consts[device]
        return normalize(compute_observations(states, obstacles, target,
                                              sm.p, others))

    @torch.no_grad()
    def collect(ts, rows: RowState, seed, noise=None):
        out = run_kernel(ts, rows, seed, noise)
        num_envs = rows.px.shape[-1]
        # Centralized critic on the emitted obs: one pass over (T*P) rows.
        values = ts.critic(out.obs.reshape(num_steps * num_envs, a, f)
                           ).reshape(num_steps, num_envs, 1)
        if cfg.use_gae:
            mean_rew = torch.mean(discounted_returns(out.rewards, out.done,
                                                     cfg.gamma))
            last_value = ts.critic(final_obs(out.rows))[:, 0]
            adv = gae_advantages(out.rewards, out.done, values[..., 0],
                                 last_value, cfg.gamma, cfg.gae_lambda)
            rets = adv + values[..., 0]
        else:
            rets, mean_rew = reference_returns(out.rewards, out.done, cfg)
        stats = EpisodeStats(*out.stats.unbind(0))
        buffer = Buffer(out.obs, out.actions, out.log_probs, values, rets,
                        out.done)
        return out.rows, buffer, RolloutMetrics(mean_rew, stats)

    # Decomposition handle: chip_smoke.py times the kernel apart from the
    # tail.
    collect.run_kernel = run_kernel
    return collect
