"""CLI: ``python -m marlnav_tpu_torch``.

The port's own copy of ``marlnav_tpu/__main__.py``'s ``build_parser``: the
same flags (short and long names) and defaults, so any invocation of the
JAX package parses here, plus ``--device`` (default ``cuda``).

The three modes of the JAX package (``main``, as marlnav_tpu/__main__.py
dispatches them):

* training (the default), with ``--jit-repeats`` and
  ``--pipeline-repeats`` (blocks of repeats, CUDA graphs on the card),
  ``--checkpoint-dir`` / ``--checkpoint-interval`` / ``--resume``,
  ``--returns-f64`` and ``--bf16-updates``;
* ``-rc`` (reward check): the scripted sampler's trajectory, its
  observation and reward series returned and plotted under ./plots
  (``-rc -sa policy`` exits: the check needs a scripted sampler);
* ``-re`` (rendering): the trajectory of the scripted sampler, or of
  trained weights with ``-sa policy -w <file>``, animated, or written to
  ``--save-animation <file>``.

``cli`` returns the mode's result: ``train()``'s tuple, the series, or
the ``Animation``.  Flags whose features are not ported yet raise
``NotImplementedError`` naming ROADMAP.md instead of being ignored:
``--num-data``, ``--num-model`` and ``--multihost``.  ``--allow-interpret``
has no counterpart (the port has no kernel interpreter: ``--device cpu``
runs the kernels' plain PyTorch versions) and raises as well.

``--fused-collect`` and ``--fused-updates`` route the rollout and the PPO
gradients through the port's CUDA kernels (ops/csrc/); on ``--device cpu``
they run the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

from marlnav_tpu_torch.config import (RunConfig, load_config_json,
                                      resolve_run_config)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="marlnav_tpu_torch",
        description="Multi-agent navigation RL (MAPPO), PyTorch/CUDA port",
    )
    # -- general (reference __main__.py:49-70) -----------------------------
    parser.add_argument("-se", "--seed", type=int,
                        help="value of the random seed (optional).")
    parser.add_argument("-mx", "--max_x_value", type=float, default=1500.0)
    parser.add_argument("-my", "--max_y_value", type=float, default=750.0)
    parser.add_argument("-fx", "--fig_size_x", type=float, default=10.0)
    parser.add_argument("-fy", "--fig_size_y", type=float, default=5.0)
    parser.add_argument("-pi", "--parallel_index", type=int, default=0)
    parser.add_argument("-ai", "--agent_index", type=int, default=0)
    parser.add_argument("-in", "--interval", type=int, default=10)
    parser.add_argument("-ra", "--random", action="store_true",
                        help="sample policy actions when rendering")
    parser.add_argument("-w", "--weights_file", type=str,
                        help="actor weights .npz under ./weights")
    # -- env (reference __main__.py:73-102) --------------------------------
    parser.add_argument("-np", "--num_parallel", type=int, default=2)
    parser.add_argument("-na", "--num_agents", type=int, default=3)
    parser.add_argument("-no", "--num_obstacles", type=int, default=3)
    parser.add_argument("-ms", "--max_step", type=int, default=1000)
    parser.add_argument("-el", "--episode_len", type=int, default=200)
    parser.add_argument("-mis", "--min_speed", type=float, default=3.0)
    parser.add_argument("-mas", "--max_speed", type=float, default=10.0)
    parser.add_argument("-mia", "--min_accel", type=float, default=-0.5)
    parser.add_argument("-maa", "--max_accel", type=float, default=0.5)
    parser.add_argument("-rf", "--risk_factor", type=float, default=0.0)
    parser.add_argument("-df", "--distance_factor", type=float, default=0.0)
    parser.add_argument("-hf", "--heading_factor", type=float, default=500.0)
    parser.add_argument("-tf", "--target_factor", type=float, default=500.0)
    parser.add_argument("-sf", "--soft_factor", type=float, default=500.0)
    parser.add_argument("-bf", "--bond_factor", type=float, default=10.0)
    # -- model (reference __main__.py:105-122) -----------------------------
    parser.add_argument("-hs", "--hidden_size", type=int, default=50)
    parser.add_argument("-lr", "--learning_rate", type=float, default=0.001)
    parser.add_argument("-ec", "--ent_const", type=float, default=0.001)
    parser.add_argument("-ep", "--epsilon", type=float, default=0.01)
    parser.add_argument("-g", "--gamma", type=float, default=0.9)
    parser.add_argument("-nt", "--num_total", type=int, default=1_000_000)
    parser.add_argument("-bl", "--buffer_len", type=int, default=1000)
    parser.add_argument("-ne", "--num_epochs", type=int, default=50)
    parser.add_argument("-bs", "--batch_size", type=int, default=1000,
                        help="mini-batch size (<= buffer_len)")
    # -- modes (reference __main__.py:125-132) -----------------------------
    parser.add_argument("-re", "--rendering", action="store_true")
    parser.add_argument("-sa", "--sampling_style", type=str,
                        default="sampler", choices=["sampler", "policy"])
    parser.add_argument("-rc", "--reward_check", action="store_true")
    parser.add_argument("-sn", "--sampler_num", type=int, default=-1,
                        choices=[-1, 0, 1])
    # -- extensions of the JAX package -------------------------------------
    parser.add_argument("--config", type=str,
                        help="load the full run config from a JSON file")
    parser.add_argument("--num-data", type=int, default=None,
                        help="data-parallel mesh axis (not ported)")
    parser.add_argument("--num-model", type=int, default=1,
                        help="tensor-parallel mesh axis (not ported)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training (not ported)")
    parser.add_argument("--coordinator-address", type=str, default=None,
                        help="host:port of process 0 for --multihost")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="total process count for --multihost")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's index for --multihost")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save full-state checkpoints here")
    parser.add_argument("--checkpoint-interval", type=int, default=10)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "--checkpoint-dir")
    parser.add_argument("--output-root", type=str, default=None,
                        help="root for plots/ logs/ weights/ (default: cwd)")
    parser.add_argument("--jit-repeats", type=int, default=1,
                        help="repeats a block: one read of metrics a block, "
                             "a CUDA graph a block on the card")
    parser.add_argument("--pipeline-repeats", action="store_true",
                        help="replay one repeat's CUDA graph --jit-repeats "
                             "times a block instead of a graph of the block")
    parser.add_argument("--save-animation", type=str, default=None,
                        help="write the animation to this file (rendering "
                             "mode)")
    parser.add_argument("--fixed-semantics", action="store_true",
                        help="corrected advantage pairing + full minibatches "
                             "instead of reference-faithful quirks")
    parser.add_argument("--use-gae", action="store_true",
                        help="bootstrapped GAE instead of zero-at-done returns")
    parser.add_argument("--fused-collect", action="store_true",
                        help="collect the rollout with the fused CUDA kernel "
                             "(triangle scenarios; its plain PyTorch version "
                             "on --device cpu)")
    parser.add_argument("--fused-updates", action="store_true",
                        help="PPO gradients from the fused CUDA kernels, "
                             "Adam outside (their plain PyTorch versions "
                             "on --device cpu)")
    parser.add_argument("--returns-f64", action="store_true",
                        help="float64 returns accumulation")
    parser.add_argument("--bf16-updates", action="store_true",
                        help="bf16 matmul operands (float32 sums) in the "
                             "PPO updates, rounded where the JAX package's "
                             "route rounds them")
    parser.add_argument("--allow-interpret", action="store_true",
                        help="JAX-package flag with no counterpart here "
                             "(raises)")
    parser.add_argument("--staggered-resets", action="store_true",
                        help="initialize per-env episode phases uniformly so "
                             "truncations decorrelate across the batch "
                             "(arXiv:2511.21011)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda; raises "
                             "when CUDA is absent — pass --device cpu)")
    return parser


# (flag, is-it-set) for every flag whose feature is not ported yet.
_UNPORTED = (
    ("--num-data", lambda a: a.num_data is not None),
    ("--num-model", lambda a: a.num_model != 1),
    ("--multihost", lambda a: a.multihost),
)


def reject_unported(args) -> None:
    """Raise for any flag whose feature the port does not have yet."""
    for flag, is_set in _UNPORTED:
        if is_set(args):
            raise NotImplementedError(
                f"{flag} is not ported to marlnav_tpu_torch yet "
                "(see ROADMAP.md); run python -m marlnav_tpu for it")
    if args.allow_interpret:
        raise NotImplementedError(
            "--allow-interpret has no counterpart in marlnav_tpu_torch: it "
            "has no kernel interpreter; --device cpu runs the kernels' "
            "plain PyTorch versions")


def main(cfg: RunConfig, mode: str, args=None):
    """Mode dispatch (marlnav_tpu/__main__.py:148-210, reference
    __main__.py:12-40); returns the mode's result."""
    device = getattr(args, "device", "cuda") if args is not None else "cuda"
    if mode == "training":
        from marlnav_tpu_torch.train import train

        return train(
            cfg, device=device,
            fused_collect=getattr(args, "fused_collect", False),
            checkpoint_dir=getattr(args, "checkpoint_dir", None),
            checkpoint_interval=getattr(args, "checkpoint_interval", 10),
            resume=getattr(args, "resume", False),
            output_root=getattr(args, "output_root", None),
            jit_repeats=getattr(args, "jit_repeats", 1),
            pipeline=getattr(args, "pipeline_repeats", False))

    from marlnav_tpu_torch.env import make_env
    from marlnav_tpu_torch.utils.seeding import make_generator

    env = make_env(cfg.env, cfg.init, device, sampler_cfg=cfg.sampler)
    generator = make_generator(cfg.seed, env.device)
    if mode == "rendering":
        from marlnav_tpu_torch.diagnostics import init_render

        renderer = init_render(
            env, cfg.animation, normalizer_cfg=cfg.normalizer,
            scaler_cfg=cfg.scaler, hidden_size=cfg.animation.hidden_size,
            generator=generator)
        renderer.run(save_path=getattr(args, "save_animation", None))
        return renderer
    if mode == "reward_check":
        from marlnav_tpu_torch.diagnostics import check_rews

        return check_rews(env, cfg.max_step, cfg.animation.parallel_index,
                          cfg.animation.agent_index, generator=generator)
    raise ValueError(f"unknown mode {mode!r}")


def cli(argv=None):
    """Parse ``argv`` and run its mode; returns the mode's result:
    ``train.train``'s (train state, final env state, stats logger), the
    reward check's series, or the rendering's ``Animation``."""
    args = build_parser().parse_args(argv)
    if args.reward_check and args.sampling_style == "policy":
        sys.exit("reward check needs a scripted sampler, not a policy")
    reject_unported(args)
    cfg = (load_config_json(args.config) if args.config
           else resolve_run_config(args))
    mode = ("rendering" if args.rendering
            else "reward_check" if args.reward_check else "training")
    return main(cfg, mode, args)


if __name__ == "__main__":
    cli()
