"""Training entry point: the outer repeat loop with stats and weights.

Port of ``marlnav_tpu/train.py`` for one device:
``num_repeats = num_total // (buffer_len * num_parallel)`` repeats of
(collect rollout -> train actor -> train critic), then the artifact dump.
The rollout runs either as the plain T-step loop over ``env.step``
(``MAPPO.collect``) or, with ``fused_collect``, through the fused collect
kernel (``ops.fused_collect``).  ``cfg.model.fused_updates`` takes the PPO
gradients from the fused update kernels (``ops.fused_update``), for the full
batch and for sliced minibatches alike; ``MARLNAV_ACTOR_LAYOUT`` picks the
actor's kernel off the JAX package's tiled route (``uncollapsed_actor``).

The reference's save-every-rollout weights quirk (its best-reward gate
never updates, reference models.py:93, 127-129) is kept: weights are
(over)written to the same timestamped file after every rollout.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from marlnav_tpu_torch.algo import make_mappo
from marlnav_tpu_torch.config import MAPPOConfig, RunConfig, config_to_json
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.utils.seeding import make_generator, resolve_device
from marlnav_tpu_torch.utils.stats import StatsLogger


def uncollapsed_actor(cfg: MAPPOConfig, fused_collect: bool) -> bool:
    """Whether a ``--fused-updates`` run takes the actor's gradient through
    the network itself, as the JAX package decides it.  Its tiled route
    (``--fused-collect``, full batch, ``MARLNAV_TILED_UPDATES`` not
    0/false/off/empty; marlnav_tpu/train.py:118-124) is always affine;
    elsewhere it runs the staged kernel of ``MARLNAV_ACTOR_LAYOUT``
    (default "affine"; marlnav_tpu/ops/fused_update.py:141, 454-461), and
    any other value there is its "packed" or "undilated" kernel, both
    un-collapsed."""
    tiled = (fused_collect and cfg.batch_size == cfg.buffer_len
             and os.environ.get("MARLNAV_TILED_UPDATES", "1").lower()
             not in ("0", "false", "off", ""))
    return (cfg.fused_updates and not tiled
            and os.environ.get("MARLNAV_ACTOR_LAYOUT", "affine") != "affine")


def train(
    cfg: RunConfig,
    device: str = "cuda",
    fused_collect: bool = False,
    output_root: Optional[str] = None,
    verbose: bool = True,
):
    """Run full MAPPO training per ``cfg`` on ``device``; returns
    ``(TrainState, final env state, StatsLogger)``.  The env state is an
    ``EnvState``, or a ``RowState`` with ``fused_collect``.

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``"cpu"`` to run on the CPU (where the fused collect runs its plain
    PyTorch version).  All randomness comes from generators seeded from
    ``cfg.seed``."""
    if cfg.model is None:
        raise ValueError("train requires a model config")
    t_start = time.perf_counter()
    dev = resolve_device(device)
    env = make_env(cfg.env, cfg.init, dev)
    mappo = make_mappo(cfg.model, env, cfg.normalizer, cfg.scaler,
                       uncollapsed_actor(cfg.model, fused_collect))
    generator = make_generator(cfg.seed, dev)
    ts, state = mappo.init(generator)

    if fused_collect:
        from marlnav_tpu_torch.ops import env_state_to_rows, make_fused_collect

        fc = make_fused_collect(cfg.model, cfg.env, cfg.init, cfg.normalizer,
                                cfg.scaler)
        state = env_state_to_rows(state)
        # Kernel seeds as in the JAX package (train.py:178-182): spread the
        # run seed, bounded below 2**30 so base_seed + repeat stays in
        # int32; the kernel keys Philox on (seed, env index).
        base_seed = ((cfg.seed if cfg.seed is not None else 0)
                     * 1_000_003) % (1 << 30)

        def do_collect(ts, state, repeat):
            return fc(ts, state, base_seed + repeat)
    else:
        def do_collect(ts, state, repeat):
            return mappo.collect(ts, state, generator)

    logger = StatsLogger(root=output_root)
    if verbose:
        print(f"setup: {time.perf_counter() - t_start:.2f}s")
    m = cfg.model
    steps_per_rollout = m.buffer_len * m.num_parallel
    for repeat in range(m.num_repeats):
        t0 = time.perf_counter()
        state, buffer, metrics = do_collect(ts, state, repeat)
        ts, actor_losses = mappo.train_actor(ts, buffer)
        ts, critic_losses = mappo.train_critic(ts, buffer)
        # Logging reads the metrics and losses back: the repeat's device
        # work has finished when it returns.
        logger.log_rollout(metrics)
        logger.log_losses(actor_losses, critic_losses)
        dt = time.perf_counter() - t0
        logger.save_weights(ts)
        if verbose:
            print(f"repeat {repeat + 1}/{m.num_repeats}: "
                  f"mean_rew {logger.logs['mean_rews'][-1]:.3f}, "
                  f"{steps_per_rollout / dt:,.0f} env-steps/s "
                  f"(1 repeat in {dt:.2f}s)")

    t0 = time.perf_counter()
    logger.save_stats(config_to_json(cfg))
    if verbose:
        print(f"artifacts written in {time.perf_counter() - t0:.2f}s")
    return ts, state, logger
