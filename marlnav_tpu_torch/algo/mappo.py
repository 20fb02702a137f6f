"""MAPPO — multi-agent PPO with a centralized critic.

Port of ``marlnav_tpu/algo/mappo.py``'s XLA update path: the rollout is a
T-step loop over ``env.step``, the updates run torch autograd plus
``torch.optim.Adam`` over epochs x minibatches.  A training repeat is
``collect -> train_actor -> train_critic``.

Faithful-semantics notes (SURVEY.md §2.5), active when ``cfg.faithful``
(default):

* Returns, not GAE: reverse loop ``curr = where(done, 0, r + gamma*curr)``
  (reference models.py:131-148), then the WHOLE buffer of returns is
  z-normalized with the unbiased sample std.
* Advantage mis-pairing: the reference tiles returns/values with
  ``Tensor.repeat`` where the log-prob flatten order needs a
  repeat-interleave (reference models.py:285-286).
* Last-step drop: a minibatch that reaches the buffer end slices to ``-1``,
  silently dropping the final buffer step (reference models.py:167-171).
* The actor objective is maximized in the reference (Adam
  ``maximize=True``); here its negation is minimized, identical
  update-for-update.

``faithful=False`` fixes the pairing and the last-step drop;
``use_gae=True`` switches the advantage estimator to bootstrapped GAE.
The reverse recursions run through the returns kernel on the card
(``ops/returns.py``), in float64 with ``returns_f64``.  ``train_many``
runs a block of repeats with nothing read back from the device, which
``train.py`` captures as one CUDA graph.

``fused_updates=True`` computes each minibatch's loss and gradients with the
hand-derived backwards of ``ops/fused_update.py`` (CUDA kernels on the card,
their plain versions on the CPU) instead of autograd; the same Adam steps
consume them (marlnav_tpu/algo/mappo.py:383-471).  The actor's gradient
goes through its affine operator, or, with ``uncollapsed_actor``, through
the network itself (the JAX package's "packed" and "undilated" kernels;
``train.py`` decides when).

Under a mesh (``make_mappo(..., mesh=...)``, a ``parallel.Mesh``;
marlnav_tpu/algo/mappo.py:292-305) each data index collects and trains
on its share of the envs, and what the JAX package's partitioner makes
global is reduced over the data group: the returns normalization (global
mean, then the global sum of squared deviations over N - 1), the GAE
``mean_rew``, the episode counters, the faithful advantage pairing
(``pair_rows_sharded``, once a phase), and each minibatch's loss and
gradients (one sum all-reduce of a flat buffer a step; shards are equal,
so the global mean is the data indices' mean).  The plain collect draws
its action noise at the global shape and keeps its rows
(``DiagGaussian.sample``'s ``shard``), so a run over N data indices
equals the run without a mesh up to the order of its sums; at one it
equals it bit for bit.

With ``num_model`` > 1 (tensor parallelism, marlnav_tpu/train.py:82-86)
``init`` keeps each rank's hidden units of the whole networks
(``parallel.tensor.shard_network``) before Adam is built, so Adam runs
on the shards.  The ranks of a model group step the same envs with the
same draws.  On the autograd route the networks' forwards sum their
heads over the model group (``models/networks.py``), each rank's
gradients are its shards', and ``_mean_over_ranks`` averages them over
the data group only.  The kernel routes take whole weights, as the JAX
package's ``shard_map`` phases take them replicated
(marlnav_tpu/algo/mappo.py:473-483): each minibatch step gathers the
network over the model group (one all-gather: Adam changes the shards at
every step), runs the kernel, sums its flat sums over the data group,
and hands each rank its shard of the gradients.

``bf16_updates`` rounds the update products' operands to bf16 (float32
sums) on every route, where the JAX route it stands for rounds them: the
losses through ``Actor`` / ``Critic`` with ``compute_dtype``, the fused
gradients through the kernels' bf16 variants; the affine actor rounds as
the JAX package's tiled kernel where ``tiled_actor`` (``train.py``
decides), else as its staged one.  The rollout stays float32.

Clip edges follow JAX's gradient rule: ``clip`` below is
``minimum(maximum(x, lo), hi)``, whose gradient at an exact bound is 1/2
(an autograd tie split), where ``torch.clamp`` passes the full gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from marlnav_tpu_torch.config import MAPPOConfig, NormalizerConfig, ScalerConfig
from marlnav_tpu_torch.env.env import Env
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.models import Actor, Critic, DiagGaussian
from marlnav_tpu_torch.parallel.sharding import (all_gather_envs,
                                                 all_reduce_sum)
from marlnav_tpu_torch.parallel.tensor import (gather_networks,
                                               shard_network, shard_tensor)
from marlnav_tpu_torch.utils.transforms import (make_action_scaler,
                                                make_obs_normalizer)


@dataclasses.dataclass
class TrainState:
    actor: Actor
    critic: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam


@dataclasses.dataclass
class Buffer:
    """Stacked rollout buffer, time-major (T leading), matching the
    reference's per-step record layout (reference models.py:121)."""

    obs: torch.Tensor  # (T, P, A, obs) normalized pre-step observations
    actions: torch.Tensor  # (T, P, A, 2) raw [-1,1]-scale sampled actions
    log_probs: torch.Tensor  # (T, P*A)
    values: torch.Tensor  # (T, P, 1) critic on pre-step obs
    returns: torch.Tensor  # (T, P) normalized discounted returns
    done: torch.Tensor  # (T, P) bool

    def time_slice(self, start: int, stop: int) -> "Buffer":
        """Steps [start, stop) of every field (views, no copy)."""
        return Buffer(*(getattr(self, f.name)[start:stop]
                        for f in dataclasses.fields(self)))


@dataclasses.dataclass
class RolloutMetrics:
    mean_rew: torch.Tensor  # () mean of unnormalized returns
    stats: EpisodeStats  # episode endings during this rollout


@dataclasses.dataclass
class MAPPO:
    """Bundle of MAPPO functions over fixed configs."""

    cfg: MAPPOConfig
    init: Callable  # generator -> (TrainState, EnvState)
    collect: Callable  # (TrainState, EnvState, generator) -> (EnvState, Buffer, RolloutMetrics)
    train_actor: Callable  # (TrainState, Buffer) -> (TrainState, losses)
    train_critic: Callable  # (TrainState, Buffer) -> (TrainState, losses)
    train_many: Callable  # (ts, es, generator, n[, collect_fn]) -> (ts, es, metrics, losses)


# ----------------------------------------------------------------------
# Returns (reference models.py:131-148)
# ----------------------------------------------------------------------

def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of ``x`` over every rank's shard (equal shards: the mean of
    the ranks' means); ``torch.mean(x)`` without a mesh, and bit for bit
    that at one rank."""
    mean = torch.mean(x)
    if mesh is None:
        return mean
    return all_reduce_sum(mean, mesh) / mesh.num_data


def _sample_std(x: torch.Tensor, mean: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Unbiased (N-1) std — torch.std_mean default (reference models.py:140)
    — of ``x`` over every rank's shard, about its ``global_mean``
    ``mean``."""
    squares, n = torch.sum((x - mean) ** 2), x.numel()
    if mesh is not None:
        squares, n = all_reduce_sum(squares, mesh), n * mesh.num_data
    return torch.sqrt(squares / (n - 1))


def discounted_returns(rewards: torch.Tensor, done: torch.Tensor,
                       gamma: float,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reverse-loop zero-at-done discounted returns
    (reference models.py:131-148), accumulated in ``dtype``.  rewards/done
    (T, P) -> returns (T, P).  Through the returns kernel
    (``ops/returns.py``) on the card, its plain loop on the CPU."""
    from marlnav_tpu_torch.ops.returns import returns_scan

    return returns_scan(rewards, done, gamma, dtype=dtype)


def reference_returns(rewards: torch.Tensor, done: torch.Tensor,
                      cfg: MAPPOConfig, mesh=None):
    """Zero-at-done discounted returns + whole-buffer z-normalization
    (reference models.py:131-148).  Returns ``(normalized (T, P) float32,
    mean of unnormalized returns)``; with a ``mesh`` the buffer is every
    rank's (T, P/world) shard together (two all-reduces: the mean, then
    the squared deviations).

    With ``cfg.returns_f64`` the accumulation, mean and std run in float64,
    the reference's ``dtype=float`` accumulator (reference models.py:133;
    marlnav_tpu/algo/mappo.py:108-131); ``mean_rew`` stays float64 and the
    normalized returns are cast back to float32 for the buffer."""
    dtype = torch.float64 if cfg.returns_f64 else torch.float32
    rets = discounted_returns(rewards, done, cfg.gamma, dtype)
    mean_rew = global_mean(rets, mesh)
    normed = (rets - mean_rew) / (_sample_std(rets, mean_rew, mesh) + 1e-12)
    return normed.to(torch.float32), mean_rew


def gae_advantages(rewards, done, values, last_value, gamma, lam):
    """Bootstrapped GAE(lambda) — the corrected estimator behind
    ``use_gae``.  rewards/done/values (T, P), last_value (P,).  Through the
    returns kernel on the card, its plain loop on the CPU."""
    from marlnav_tpu_torch.ops.returns import returns_scan

    return returns_scan(rewards, done, gamma, values, last_value, lam)


# ----------------------------------------------------------------------
# Losses (reference models.py:270-316)
# ----------------------------------------------------------------------

def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with its gradient: ``minimum(maximum(x, lo), hi)``.
    At an exact bound autograd splits the tie, passing half the gradient
    to ``x`` as JAX does; ``torch.clamp`` would pass all of it.  A number
    bound becomes a tensor filled on ``x``'s device (no copy from the host,
    so a CUDA graph can capture it)."""
    if not torch.is_tensor(lo):
        lo = x.new_full((), lo)
    if not torch.is_tensor(hi):
        hi = x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _flatten_minibatch(mb: Buffer, cfg: MAPPOConfig):
    """Concatenate a (size, ...) minibatch along the step axis the way the
    reference's ``torch.cat(..., dim=0)`` does (reference models.py:272-277)."""
    size = mb.obs.shape[0]
    p, a = cfg.num_parallel, cfg.num_agents
    return (mb.obs.reshape(size * p, a, cfg.obs_size),
            mb.actions.reshape(size * p * a, cfg.action_size),
            mb.log_probs.reshape(size * p * a),
            mb.values.reshape(size * p),
            mb.returns.reshape(size * p))


def _pair_per_agent(x: torch.Tensor, cfg: MAPPOConfig) -> torch.Tensor:
    """Expand (size*P,) to (size*P*A,) to pair with per-agent log-probs.

    faithful: ``Tensor.repeat`` tiling (reference models.py:285-286) — the
    verified mis-pairing.  fixed: repeat-interleave, the correct
    (step, env, agent) pairing."""
    if cfg.faithful:
        return x.repeat(cfg.num_agents)
    return torch.repeat_interleave(x, cfg.num_agents)


def pair_rows_sharded(d: torch.Tensor, num_agents: int, faithful: bool,
                      mesh) -> torch.Tensor:
    """This rank's rows of the per-agent pairing over the GLOBAL env batch
    (marlnav_tpu/ops/fused_update.py:200-222 ``_pair_rows_sharded``).

    ``d`` is this rank's (size, P_local) returns - values.  The fixed
    (repeat-interleave) pairing is local: global row (t, p, a) reads d[t,
    p], which the rank holds for its own rows.  The faithful pairing is
    the reference's flat tile over the global (size*P,) vector: global row
    j = (t*P + p)*A + a reads d_flat[j mod size*P], across shard
    boundaries, so d is all-gathered over the data group and the rank
    takes its own rows' entries.  Returns the rank's (size*P_local*A,)
    advantages in its local (t, p_local, a) row order."""
    if not faithful:
        return torch.repeat_interleave(d.reshape(-1), num_agents)
    size, p_local = d.shape
    d_global = all_gather_envs(d, mesh, dim=1)
    p_global = d_global.shape[1]
    dev = d.device
    j = ((torch.arange(size, device=dev)[:, None, None] * p_global
          + (mesh.data_index * p_local
             + torch.arange(p_local, device=dev))[None, :, None]) * num_agents
         + torch.arange(num_agents, device=dev)[None, None, :])
    return d_global.reshape(-1)[j.reshape(-1) % (size * p_global)]


def minibatch_advantages(mb: Buffer, cfg: MAPPOConfig,
                         mesh=None) -> torch.Tensor:
    """(size*P*A,) advantages in the minibatch's (step, env, agent) row
    order: returns - values paired per agent within the slice, so the
    faithful tiling wraps modulo size*P (reference models.py:285-286).
    With a ``mesh``, this rank's rows of the pairing over every rank's
    envs (``pair_rows_sharded``)."""
    if mesh is not None:
        return pair_rows_sharded(mb.returns - mb.values[..., 0],
                                 cfg.num_agents, cfg.faithful, mesh)
    _, _, _, values, returns = _flatten_minibatch(mb, cfg)
    return _pair_per_agent(returns, cfg) - _pair_per_agent(values, cfg)


def _compute_dtype(cfg: MAPPOConfig):
    """The update losses' matmul operand dtype (marlnav_tpu/algo/
    mappo.py:246, 266)."""
    return torch.bfloat16 if cfg.bf16_updates else None


def actor_loss(actor: Actor, mb: Buffer, cfg: MAPPOConfig,
               advantages: torch.Tensor = None) -> torch.Tensor:
    """Negated PPO-clip + entropy objective (the reference *maximizes* it,
    reference models.py:71-72, 270-299); ``advantages`` default to
    ``minibatch_advantages(mb, cfg)``."""
    obs, actions, old_log_probs, _, _ = _flatten_minibatch(mb, cfg)
    mean, var = actor(obs, _compute_dtype(cfg))
    dist = DiagGaussian(mean, var)
    new_log_probs = dist.log_prob(actions)
    entropies = dist.entropy()

    if advantages is None:
        advantages = minibatch_advantages(mb, cfg)
    ratios = torch.exp(new_log_probs - old_log_probs)
    clip_obj = torch.mean(torch.minimum(
        ratios * advantages,
        clip(ratios, 1.0 - cfg.epsilon, 1.0 + cfg.epsilon) * advantages))
    return -(clip_obj + cfg.ent_const * torch.mean(entropies))


def critic_loss(critic: Critic, mb: Buffer, cfg: MAPPOConfig) -> torch.Tensor:
    """Clipped-value loss (reference models.py:301-316)."""
    obs, _, _, values, returns = _flatten_minibatch(mb, cfg)
    new_values = critic(obs, _compute_dtype(cfg))[:, 0]
    diff = (new_values - returns) ** 2
    clamped = clip(new_values, values - cfg.epsilon, values + cfg.epsilon)
    clamped_diff = (clamped - returns) ** 2
    return torch.mean(torch.maximum(diff, clamped_diff))


def minibatch_slices(buffer: Buffer, cfg: MAPPOConfig):
    """Contiguous time-slices per the reference's minibatching
    (reference models.py:165-172): full batches, plus — in faithful mode
    when the last batch reaches the buffer end — a tail batch with the
    final buffer step dropped."""
    slices = []
    bs = cfg.batch_size
    for j in range(cfg.num_minibatches):
        start = j * bs
        if cfg.faithful and start + bs >= cfg.buffer_len:
            size = cfg.buffer_len - 1 - start  # slice end == -1
        else:
            size = bs
        slices.append(buffer.time_slice(start, start + size))
    return slices


# ----------------------------------------------------------------------
# The MAPPO bundle
# ----------------------------------------------------------------------

def global_stats(stats: EpisodeStats, mesh=None) -> EpisodeStats:
    """The episode counters summed over the ranks (one all-reduce);
    ``stats`` itself without a mesh."""
    if mesh is None:
        return stats
    counters = torch.stack([stats.num_trunc, stats.num_col, stats.num_tar])
    return EpisodeStats(*all_reduce_sum(counters, mesh).unbind(0))


def _mean_over_ranks(loss: torch.Tensor, params, mesh) -> torch.Tensor:
    """Average a minibatch's loss and its parameters' gradients (this
    rank's shards under tensor parallelism) over the data group in one
    all-reduce of a flat buffer; the gradients become views of it.
    Returns the averaged loss."""
    params = list(params)
    flat = torch.cat([loss.reshape(1)]
                     + [q.grad.reshape(-1) for q in params])
    flat = all_reduce_sum(flat, mesh) / mesh.num_data
    start = 1
    for q in params:
        q.grad = flat[start:start + q.numel()].view_as(q)
        start += q.numel()
    return flat[0]


def make_adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over ``module``'s parameters at torch's defaults (betas
    0.9/0.999, eps 1e-8: optax.adam's).  On the card it is capturable (its
    step count lives on the device, so a CUDA graph can hold its steps) and
    fused (one kernel a step); eager and graphed runs take the same
    settings, so they stay bitwise equal.  On the CPU it is torch's default
    Adam."""
    if next(module.parameters()).device.type == "cuda":
        return torch.optim.Adam(module.parameters(), lr=lr, capturable=True,
                                fused=True)
    return torch.optim.Adam(module.parameters(), lr=lr)


def local_config(cfg: MAPPOConfig, mesh) -> MAPPOConfig:
    """``cfg`` as one rank of ``mesh`` sees it: its data index's share of
    the envs and of ``num_total``, so ``num_repeats`` stays the run's."""
    if mesh is None:
        return cfg
    _, count = mesh.env_slice(cfg.num_parallel)
    return dataclasses.replace(cfg, num_parallel=count,
                               num_total=cfg.num_total // mesh.num_data)


def make_mappo(cfg: MAPPOConfig, env: Env, normalizer_cfg: NormalizerConfig,
               scaler_cfg: ScalerConfig, uncollapsed_actor: bool = False,
               tiled_actor: bool = False, mesh=None) -> MAPPO:
    """Build the MAPPO function bundle on ``env.device``.  The train
    functions update the networks and optimizers of ``ts`` in place.
    With ``cfg.fused_updates``, the actor's gradient goes through its
    affine operator, or through the network itself where
    ``uncollapsed_actor``; with ``cfg.bf16_updates`` too, the affine one
    rounds as the JAX package's tiled kernel where ``tiled_actor``, else
    as its staged one.  With a ``mesh`` (``parallel.Mesh``) ``cfg``
    is the whole run's and ``env`` this rank's (``make_env(...,
    mesh=mesh)``); the bundle's ``cfg`` is the rank's
    (``local_config``)."""
    device = env.device
    normalize = make_obs_normalizer(normalizer_cfg, device)
    scale_up = make_action_scaler(scaler_cfg, device)
    p_global = cfg.num_parallel
    cfg = local_config(cfg, mesh)
    p, a = cfg.num_parallel, cfg.num_agents
    # The plain collect's action noise: the global draw, this rank's rows.
    noise_shard = None if mesh is None else (
        p_global * a, mesh.env_slice(p_global)[0] * a)

    def init(generator: torch.Generator):
        """Networks drawn from a CPU generator seeded from ``generator``'s
        seed (so CPU and CUDA runs start from the same weights), each
        rank's hidden units kept under tensor parallelism; the env draws
        from ``generator`` itself."""
        g_cpu = torch.Generator().manual_seed(generator.initial_seed())
        actor = shard_network(Actor(cfg.obs_size, cfg.hidden_size,
                                    cfg.action_size, generator=g_cpu)
                              .to(device), mesh)
        critic = shard_network(Critic(cfg.obs_size, a, cfg.hidden_size,
                                      generator=g_cpu).to(device), mesh)
        ts = TrainState(actor, critic, make_adam(actor, cfg.lr),
                        make_adam(critic, cfg.lr))
        return ts, env.init(generator)

    @torch.no_grad()
    def collect(ts: TrainState, env_state: EnvState,
                generator: torch.Generator):
        """The rollout (reference models.py:106-129 ``get_data``); action
        noise from ``generator``, reset draws from the env's generator."""
        # Stats counters are harvested per rollout and reset
        # (reference models.py:151-158).
        env_state = dataclasses.replace(env_state,
                                        stats=EpisodeStats.zeros(device))
        obs = normalize(env.observations(env_state))
        records = []
        for _ in range(cfg.buffer_len):
            mean, var = ts.actor(obs)
            dist = DiagGaussian(mean, var)
            flat_actions = dist.sample(generator, noise_shard)  # (P*A, 2)
            log_probs = dist.log_prob(flat_actions)  # (P*A,)
            actions = flat_actions.reshape(p, a, cfg.action_size)
            env_state, out = env.step(env_state, scale_up(actions))
            values = ts.critic(obs)  # pre-step obs (P, 1)
            records.append((obs, actions, log_probs, values, out.rewards,
                            out.terminated | out.truncated))
            obs = normalize(out.obs)
        obs_b, actions, log_probs, values, rewards, done = (
            torch.stack(x) for x in zip(*records))

        if cfg.use_gae:
            # Bootstrapped GAE advantages stored as "returns" = advantage +
            # value, so the losses still read returns - values.
            mean_rew = global_mean(discounted_returns(rewards, done,
                                                      cfg.gamma), mesh)
            last_value = ts.critic(obs)[:, 0]
            adv = gae_advantages(rewards, done, values[..., 0], last_value,
                                 cfg.gamma, cfg.gae_lambda)
            rets = adv + values[..., 0]
        else:
            rets, mean_rew = reference_returns(rewards, done, cfg, mesh)

        env_state = dataclasses.replace(
            env_state, stats=global_stats(env_state.stats, mesh))
        buffer = Buffer(obs_b, actions, log_probs, values, rets, done)
        return env_state, buffer, RolloutMetrics(mean_rew, env_state.stats)

    if cfg.fused_updates:
        from marlnav_tpu_torch.ops.fused_update import (
            actor_grad, actor_grad_uncollapsed, critic_grad)

        def sharded(step):
            """``step`` on the whole network, its gradients cut to this
            rank's shards (itself without tensor parallelism)."""
            def run(m, mb, staged):
                (whole,) = gather_networks([m])
                loss, grads = step(whole, mb, staged)
                return loss, {k: shard_tensor(k, g, mesh)
                              for k, g in grads.items()}
            return run

        # (module, minibatch, staged) -> (loss, grads by parameter name)
        @sharded
        def actor_step(m, mb, adv):
            if uncollapsed_actor:
                return actor_grad_uncollapsed(m, mb, adv, cfg, mesh)
            return actor_grad(m, mb, adv, cfg, tiled_actor, mesh)

        @sharded
        def critic_step(m, mb, _):
            return critic_grad(m, mb, cfg, mesh)
    else:
        actor_step = critic_step = None

    def _train_phase(loss_fn, grad_fn, stage_fn, get_module, get_opt):
        def train(ts: TrainState, buffer: Buffer):
            """Epochs x minibatches of Adam steps (reference
            models.py:160-198); returns ``(ts, losses)``, the per-minibatch
            losses as one (epochs * minibatches,) tensor.  Each slice's
            advantages are staged once per phase, not per epoch."""
            module, opt = get_module(ts), get_opt(ts)
            slices = minibatch_slices(buffer, cfg)
            params = dict(module.named_parameters())
            staged = [stage_fn(mb) for mb in slices]
            losses = []
            for _ in range(cfg.num_epochs):
                for i, mb in enumerate(slices):
                    if grad_fn is None:
                        loss = loss_fn(module, mb, staged[i])
                        opt.zero_grad(set_to_none=True)
                        loss.backward()
                        if mesh is not None:
                            loss = _mean_over_ranks(loss.detach(),
                                                    params.values(), mesh)
                    else:
                        loss, grads = grad_fn(module, mb, staged[i])
                        for name, g in grads.items():
                            params[name].grad = g
                    opt.step()
                    losses.append(loss.detach())
            return ts, torch.stack(losses)

        return train

    train_actor = _train_phase(
        lambda m, mb, adv: actor_loss(m, mb, cfg, adv), actor_step,
        lambda mb: minibatch_advantages(mb, cfg, mesh),
        lambda ts: ts.actor, lambda ts: ts.actor_opt)
    train_critic = _train_phase(
        lambda m, mb, _: critic_loss(m, mb, cfg), critic_step,
        lambda mb: None, lambda ts: ts.critic, lambda ts: ts.critic_opt)

    def train_many(ts: TrainState, env_state, generator: torch.Generator,
                   num_repeats: int, collect_fn: Callable = None):
        """``num_repeats`` full (collect -> train actor -> train critic)
        cycles (marlnav_tpu/algo/mappo.py:511 train_many).
        ``collect_fn(ts, env_state, i)`` collects repeat ``i`` of the block
        in place of the plain collect with ``generator`` (the fused route
        passes its kernel's).  Returns ``(ts, env_state, metrics,
        actor_losses, critic_losses)``, stacked over the repeats: the
        metrics' fields (n,), the losses (n, epochs * minibatches).  Nothing
        here reads the device, so a CUDA graph can capture a block."""
        if collect_fn is None:
            def collect_fn(ts_, es, _):
                return collect(ts_, es, generator)
        per_repeat = []
        for i in range(num_repeats):
            env_state, buffer, metrics = collect_fn(ts, env_state, i)
            ts, actor_losses = train_actor(ts, buffer)
            ts, critic_losses = train_critic(ts, buffer)
            per_repeat.append((metrics, actor_losses, critic_losses))
        metrics, actor_losses, critic_losses = zip(*per_repeat)
        stats = EpisodeStats(*(
            torch.stack([getattr(m.stats, f.name) for m in metrics])
            for f in dataclasses.fields(EpisodeStats)))
        return (ts, env_state,
                RolloutMetrics(torch.stack([m.mean_rew for m in metrics]),
                               stats),
                torch.stack(actor_losses), torch.stack(critic_losses))

    return MAPPO(cfg, init, collect, train_actor, train_critic, train_many)
