"""Training entry point: the outer repeat loop with stats, weights and
checkpoints.

Port of ``marlnav_tpu/train.py``:
``num_repeats = num_total // (buffer_len * num_parallel)`` repeats of
(collect rollout -> train actor -> train critic), then the artifact dump.
The rollout runs either as the plain T-step loop over ``env.step``
(``MAPPO.collect``) or, with ``fused_collect``, through the fused collect
kernel (``ops.fused_collect``).  ``cfg.model.fused_updates`` takes the PPO
gradients from the fused update kernels (``ops.fused_update``), for the full
batch and for sliced minibatches alike; ``MARLNAV_ACTOR_LAYOUT`` picks the
actor's kernel off the JAX package's tiled route (``uncollapsed_actor``),
and ``cfg.model.bf16_updates`` rounds the affine actor's sums as the route
the JAX package takes (``tiled_route``).

Blocks (marlnav_tpu/train.py:238-339): repeats run in full blocks of
``jit_repeats``, and a partial tail one repeat at a time.  A block's
metrics and losses come back to the host in one read; then the weights and
(with ``checkpoint_dir``) a checkpoint are saved once.  On the card every
full block after the first is a CUDA graph, captured once and replayed:
``MAPPO.train_many`` over the block, or, with ``pipeline``, one repeat
replayed ``jit_repeats`` times (the JAX package's chained dispatches).  The
first full block and the partial tail run eagerly: the first builds the
kernels' libraries and creates Adam's state, so nothing is built or
created under capture.  A graphed block equals the eager loop bit for bit:
the fused route writes its kernel seeds, ``base_seed + repeat``, into
device memory before each replay; the plain route's generator is
registered with the graph; Adam takes the same settings on both
(``algo.mappo.make_adam``).  On the CPU the same blocks run without
capture.

Checkpoints (``utils.checkpoint``) hold both networks and Adam states, the
env state in the canonical ``EnvState`` layout even under
``fused_collect`` (so a resume works across a flip of that flag), the
generator's state, the repeat index and the logger's host state; ``resume``
continues from the latest bit for bit.  A checkpoint written on one
device type resumes on the other, as the JAX package restores onto any
device: the running Adam keeps its own settings (``restore_adam``), and a
generator state of the other device's kind seeds the running generator
(``restore_generator``).

Data and tensor parallelism (``mesh``, a ``parallel.Mesh``;
marlnav_tpu/train.py:38, 82-86): each data index trains on its share of
the envs, each model index on its hidden units of the networks (the same
on every rank of a data column, checked at set-up), and the collectives
of ``algo.mappo`` and ``ops`` keep the run global.  Only rank 0 writes
weights, logs, plots and checkpoints.  A checkpoint holds the global env
state, gathered over the data group, and the whole networks and Adam
states, gathered over the model group, and every rank takes its share on
resume, so a run resumes at another grid or without one; the weight
files hold the whole networks too.  Graphed blocks hold the collectives
(NCCL); the first full block runs eagerly, so NCCL's communicators exist
before any capture.  Over gloo (several ranks on one card) every block
runs eagerly.

The reference's save-every-rollout weights quirk (its best-reward gate
never updates, reference models.py:93, 127-129) is kept: weights are
(over)written to the same timestamped file after every block.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional

import torch

from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.algo.mappo import RolloutMetrics
from marlnav_tpu_torch.config import MAPPOConfig, RunConfig, config_to_json
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.env.types import EnvState, EpisodeStats
from marlnav_tpu_torch.parallel.tensor import gather_networks
from marlnav_tpu_torch.utils.seeding import make_generator, resolve_device
from marlnav_tpu_torch.utils.stats import StatsLogger

_ENV_FIELDS = ("states", "obstacles", "target", "step_num", "terminates",
               "reset_states", "virgin")


def tiled_route(cfg: MAPPOConfig, fused_collect: bool) -> bool:
    """Whether the JAX package runs its tiled update kernels here:
    ``--fused-updates`` with ``--fused-collect`` at full batch, and
    ``MARLNAV_TILED_UPDATES`` not 0/false/off/empty
    (marlnav_tpu/train.py:118-124); elsewhere its staged ones."""
    return (cfg.fused_updates and fused_collect
            and cfg.batch_size == cfg.buffer_len
            and os.environ.get("MARLNAV_TILED_UPDATES", "1").lower()
            not in ("0", "false", "off", ""))


def uncollapsed_actor(cfg: MAPPOConfig, fused_collect: bool) -> bool:
    """Whether a ``--fused-updates`` run takes the actor's gradient through
    the network itself, as the JAX package decides it.  Its tiled route
    (``tiled_route``) is always affine; elsewhere it runs the staged kernel
    of ``MARLNAV_ACTOR_LAYOUT`` (default "affine";
    marlnav_tpu/ops/fused_update.py:141, 454-461), and any other value
    there is its "packed" or "undilated" kernel, both un-collapsed."""
    return (cfg.fused_updates and not tiled_route(cfg, fused_collect)
            and os.environ.get("MARLNAV_ACTOR_LAYOUT", "affine") != "affine")


def fold_seed(seed: Optional[int], step: int) -> int:
    """The reset generator's seed in a checkpoint the fused route writes at
    ``step``: that route threads no generator, so each checkpoint gets a
    stream of its own for a resume on the plain route, as
    ``jax.random.fold_in(loop_rng, step)`` gives (marlnav_tpu/train.py:
    184-191)."""
    return ((0 if seed is None else seed) * 1_000_003
            + 7_919 * (step + 1)) % (1 << 62)


def pack_block(metrics: RolloutMetrics, actor_losses: torch.Tensor,
               critic_losses: torch.Tensor) -> torch.Tensor:
    """A block's stacked metrics and losses as one (n, 4 + 2L) float64
    tensor, [mean_rew, truncations, collisions, in target, L actor losses,
    L critic losses] a repeat, read back in one copy (float64 holds every
    float32 and int32 value exactly)."""
    s = metrics.stats
    cols = [x.double()[:, None] for x in
            (metrics.mean_rew, s.num_trunc, s.num_col, s.num_tar)]
    return torch.cat(cols + [actor_losses.double(), critic_losses.double()],
                     1)


def log_block(logger: StatsLogger, rows, n_losses: int) -> None:
    """Log each repeat of a block from its host copy (``pack_block``)."""
    for row in rows:
        logger.log_rollout(RolloutMetrics(
            row[0], EpisodeStats(*(int(v) for v in row[1:4]))))
        logger.log_losses(torch.from_numpy(row[4:4 + n_losses]),
                          torch.from_numpy(row[4 + n_losses:]))


def checkpoint_tree(ts, env_state: EnvState) -> dict:
    """What a checkpoint holds besides the repeat index and the logger:
    whole networks and Adam states (under tensor parallelism gathered over
    the model group, so every rank of it calls this)."""
    from marlnav_tpu_torch.parallel.tensor import (whole_adam_state,
                                                   whole_state_dict)

    return {
        "actor": whole_state_dict(ts.actor),
        "critic": whole_state_dict(ts.critic),
        "actor_opt": whole_adam_state(ts.actor_opt, ts.actor),
        "critic_opt": whole_adam_state(ts.critic_opt, ts.critic),
        "env": {name: getattr(env_state, name) for name in _ENV_FIELDS},
        "env_stats": [env_state.stats.num_trunc, env_state.stats.num_col,
                      env_state.stats.num_tar],
        "generator": env_state.generator.get_state()}


# Adam's settings that follow the device it runs on (algo.mappo.make_adam),
# not the checkpoint it resumes from.
_ADAM_DEVICE_SETTINGS = ("capturable", "fused", "foreach")


def restore_adam(opt: torch.optim.Optimizer, state: dict) -> None:
    """Load an Adam ``state`` dict into ``opt`` in place, keeping ``opt``'s
    own device settings (capturable, fused, foreach): a state written on
    the CPU (neither) resumes on the card as its capturable, fused Adam,
    and the other way round.  Each ``step`` count goes where those
    settings keep it: beside its parameter where capturable or fused, else
    on the CPU."""
    kept = [{k: group[k] for k in _ADAM_DEVICE_SETTINGS if k in group}
            for group in opt.param_groups]
    opt.load_state_dict(state)
    for group, settings in zip(opt.param_groups, kept):
        group.update(settings)
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            st = opt.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(
                    device=p.device if on_device else "cpu",
                    dtype=torch.float32)


def restore_generator(generator: torch.Generator,
                      state: torch.Tensor) -> None:
    """Set ``generator`` to a checkpoint's generator ``state``.  A state of
    the other device's kind (the CPU's Mersenne Twister against the card's
    Philox: another size) cannot continue its stream here; it seeds the
    generator from a hash of its bytes instead, so the resume stays
    deterministic, though its draws are not the ones the writing device
    would have made."""
    if state.numel() == generator.get_state().numel():
        generator.set_state(state)
        return
    digest = hashlib.sha256(state.cpu().numpy().tobytes()).digest()
    generator.manual_seed(int.from_bytes(digest[:8], "little") >> 2)


def restore_tree(tree: dict, ts, generator: torch.Generator,
                 device: torch.device, mesh=None) -> EnvState:
    """Load a checkpoint's networks, Adam states and generator state into
    ``ts`` and ``generator`` in place (each rank's hidden units of them
    under tensor parallelism); return its env state on ``device``."""
    from marlnav_tpu_torch.parallel.tensor import (shard_adam_state,
                                                   shard_state_dict)

    for net, opt in (("actor", "actor_opt"), ("critic", "critic_opt")):
        module = getattr(ts, net)
        module.load_state_dict(shard_state_dict(tree[net], mesh))
        restore_adam(getattr(ts, opt),
                     shard_adam_state(tree[opt], module, mesh))
    restore_generator(generator, tree["generator"])
    env = {k: v.to(device) if torch.is_tensor(v) else v
           for k, v in tree["env"].items()}
    return EnvState(stats=EpisodeStats(*(x.to(device) for x in
                                         tree["env_stats"])),
                    generator=generator, **env)


def _copy_state(static, new) -> None:
    """Copy the env state ``new`` (an ``EnvState`` or a ``RowState``) into
    the tensors of ``static``, the same kind."""
    if isinstance(static, EnvState):
        pairs = [(getattr(static, n), getattr(new, n))
                 for n in ("states", "obstacles", "target", "step_num",
                           "terminates", "reset_states")]
        pairs += zip((static.stats.num_trunc, static.stats.num_col,
                      static.stats.num_tar),
                     (new.stats.num_trunc, new.stats.num_col,
                      new.stats.num_tar))
    else:
        pairs = zip(static.fields(), new.fields())
    for dst, src in pairs:
        if dst is not None and dst is not src:
            dst.copy_(src)


class _Blocks:
    """Runs blocks of repeats, eagerly or as a CUDA graph.

    The graph is captured at the first graphed block, from the state the
    eager blocks left: its input is that state's tensors, into which the
    captured work copies the block's final state; its outputs are a static
    (n, 4 + 2L) tensor of ``pack_block`` rows."""

    def __init__(self, mappo, ts, generator, collect_fn, seeds, offsets,
                 base_seed: int, size: int, pipeline: bool):
        self.mappo, self.ts, self.generator = mappo, ts, generator
        self.collect_fn = collect_fn
        self.seeds, self.offsets, self.base_seed = seeds, offsets, base_seed
        self.size, self.pipeline = size, pipeline
        self.graph = self.static_state = self.out = self.block_out = None

    def write_seeds(self, repeat: int, n: int) -> None:
        """The fused route's kernel seeds of repeats ``repeat .. + n``, in
        device memory (``base_seed + repeat``, as the JAX package's
        streams derive from absolute repeat numbers)."""
        torch.add(self.offsets[:n], self.base_seed + repeat,
                  out=self.seeds[:n])

    def _run(self, state, n: int):
        _, state, metrics, al, cl = self.mappo.train_many(
            self.ts, state, self.generator, n, self.collect_fn)
        return state, pack_block(metrics, al, cl)

    def eager(self, state, repeat: int, n: int):
        """``(state, rows)`` of ``n`` repeats from ``repeat``."""
        self.write_seeds(repeat, n)
        return self._run(state, n)

    def graphed(self, state, repeat: int):
        """``(state, rows)`` of a full block from ``repeat``, replaying the
        graph (captured here the first time)."""
        from marlnav_tpu_torch.ops.graphs import CountedGraph

        if self.graph is None:
            n = 1 if self.pipeline else self.size
            self.graph = CountedGraph(
                () if self.collect_fn is not None else (self.generator,))
            self.static_state = state
            with self.graph.capture():
                new_state, self.out = self._run(state, n)
                _copy_state(self.static_state, new_state)
            if self.pipeline:  # the block's rows, one replay's at a time
                self.block_out = self.out.new_empty(
                    (self.size,) + tuple(self.out.shape[1:]))
        if not self.pipeline:
            self.write_seeds(repeat, self.size)
            self.graph.replay()
            return self.static_state, self.out
        for i in range(self.size):
            self.write_seeds(repeat + i, 1)
            self.graph.replay()
            self.block_out[i].copy_(self.out[0])
        return self.static_state, self.block_out


def train(
    cfg: RunConfig,
    device: str = "cuda",
    fused_collect: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_interval: int = 10,
    resume: bool = False,
    output_root: Optional[str] = None,
    verbose: bool = True,
    jit_repeats: int = 1,
    pipeline: bool = False,
    mesh=None,
):
    """Run full MAPPO training per ``cfg`` on ``device``; returns
    ``(TrainState, final env state, StatsLogger)``.  The env state is an
    ``EnvState``, or a ``RowState`` with ``fused_collect``.

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``"cpu"`` to run on the CPU (where the kernels run their plain PyTorch
    versions).  All randomness comes from generators and kernel seeds
    derived from ``cfg.seed``.  ``jit_repeats`` repeats make a block, as
    graphs on the card (``pipeline``: one repeat's graph replayed); with
    ``checkpoint_dir`` the complete state checkpoints every
    ``checkpoint_interval`` repeats, and ``resume`` continues from the
    latest checkpoint there.  With a ``mesh`` the run is data-parallel,
    on the mesh's device (of ``device``'s type), tensor-parallel where its
    ``num_model`` > 1, and the returned env state and networks are this
    rank's."""
    if cfg.model is None:
        raise ValueError("train requires a model config")
    if jit_repeats < 1:
        raise ValueError(f"jit_repeats must be >= 1, got {jit_repeats}")
    t_start = time.perf_counter()
    dev = resolve_device(device)
    rank0 = mesh is None or mesh.rank == 0
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"device {device!r} but the mesh is on "
                             f"{mesh.device}")
        dev = mesh.device
    env = make_env(cfg.env, cfg.init, dev, mesh=mesh)
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler,
                       uncollapsed_actor(cfg.model, fused_collect),
                       tiled_route(cfg.model, fused_collect), mesh)
    generator = make_generator(cfg.seed, dev)
    ts, state = mappo.init(generator)
    if mesh is not None:
        from marlnav_tpu_torch.parallel import (check_replicated,
                                                gather_env_state,
                                                shard_env_state)

        check_replicated([ts.actor, ts.critic], mesh)
    # The fused route's kernel seeds of a block, in device memory.
    seeds = torch.zeros(jit_repeats, dtype=torch.int32, device=dev)
    offsets = torch.arange(jit_repeats, dtype=torch.int32, device=dev)

    if fused_collect:
        from marlnav_tpu_torch.ops import (env_state_to_rows,
                                           make_fused_collect,
                                           rows_to_env_state)

        fc = make_fused_collect(cfg.model, cfg.env, cfg.init, cfg.normalizer,
                                cfg.scaler, mesh)
        # Kernel seeds as in the JAX package (train.py:178-182): spread the
        # run seed, bounded below 2**30 so base_seed + repeat stays in
        # int32; the kernel keys Philox on (seed, env index), and under a
        # mesh ``fc`` adds the rank's ``rank << 20``.
        base_seed = ((cfg.seed if cfg.seed is not None else 0)
                     * 1_000_003) % (1 << 30)

        def collect_fn(ts, rows, i):
            return fc(ts, rows, seeds[i])

        def to_canonical(rows, step):
            return rows_to_env_state(
                rows, make_generator(fold_seed(cfg.seed, step), dev))

        from_canonical = env_state_to_rows
        state = env_state_to_rows(state)
    else:
        base_seed, collect_fn = 0, None  # the plain collect, on generator

        def to_canonical(es, step):
            return es

        def from_canonical(es):
            return es

    verbose = verbose and rank0
    logger = StatsLogger(root=output_root, writes=rank0)
    start_repeat = 0
    ckpt = None
    if checkpoint_dir is not None:
        from marlnav_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir, save_interval=checkpoint_interval,
                            writes=rank0)
        if resume and ckpt.latest_step() is not None:
            # The canonical EnvState layout whatever the route, so a resume
            # works across a --fused-collect flip; the global env state,
            # of which each rank takes its share.
            step, tree, host = ckpt.restore()
            restored = restore_tree(tree, ts, generator, dev, mesh)
            if mesh is not None:
                restored = shard_env_state(restored, mesh)
            state = from_canonical(restored)
            start_repeat = step + 1
            if host:
                logger.load_state_dict(host)
            if verbose:
                print(f"resumed from checkpoint at repeat {step}")

    def save_checkpoint(step: int) -> None:
        """Checkpoint after repeat ``step`` (every rank gathers; rank 0
        writes)."""
        canon = to_canonical(state, step)
        if mesh is not None:
            canon = gather_env_state(canon, mesh)
        ckpt.save(step, checkpoint_tree(ts, canon), logger.state_dict(),
                  force=True)

    if verbose:
        print(f"setup: {time.perf_counter() - t_start:.2f}s")
    m = cfg.model
    n_losses = m.num_epochs * m.num_minibatches
    steps_per_rollout = m.buffer_len * m.num_parallel
    blocks = _Blocks(mappo, ts, generator, collect_fn, seeds, offsets,
                     base_seed, jit_repeats, pipeline)
    # Gloo stages collectives through the host: no graph holds them.
    can_graph = dev.type == "cuda" and (mesh is None
                                        or mesh.backend == "nccl")
    warmed = False
    repeat = start_repeat
    while repeat < m.num_repeats:
        remaining = m.num_repeats - repeat
        block = jit_repeats if remaining >= jit_repeats else 1
        t0 = time.perf_counter()
        if block > 1 and can_graph and warmed:
            state, rows = blocks.graphed(state, repeat)
        else:
            state, rows = blocks.eager(state, repeat, block)
            warmed = warmed or block > 1
        rows = rows.cpu().numpy()  # the block's one read; it waits for it
        dt = time.perf_counter() - t0

        log_block(logger, rows, n_losses)
        # Whole networks (gathered over the model group by every rank).
        actor, critic = gather_networks([ts.actor, ts.critic])
        logger.save_weights(dataclasses.replace(ts, actor=actor,
                                                critic=critic))
        if ckpt is not None:
            # Save when this block contains a multiple of the interval
            # (marlnav_tpu/train.py:314-322).
            last = repeat + block - 1
            crosses = (last // ckpt.save_interval) > ((repeat - 1)
                                                      // ckpt.save_interval)
            if crosses:
                save_checkpoint(last)
        if verbose:
            print(f"repeat {repeat + block}/{m.num_repeats}: "
                  f"mean_rew {logger.logs['mean_rews'][-1]:.3f}, "
                  f"{block * steps_per_rollout / dt:,.0f} env-steps/s "
                  f"({block} repeat(s) in {dt:.2f}s)")
        repeat += block

    if ckpt is not None and m.num_repeats > start_repeat:
        save_checkpoint(m.num_repeats - 1)
        ckpt.close()
    t0 = time.perf_counter()
    logger.save_stats(config_to_json(cfg))
    if verbose:
        print(f"artifacts written in {time.perf_counter() - t0:.2f}s")
    return ts, state, logger
