"""marlnav_tpu_torch — the PyTorch/CUDA port of ``marlnav_tpu``.

The same batched 2-D multi-agent navigation environment and MAPPO trainer,
written in PyTorch for one NVIDIA H100, with the JAX package's Pallas
kernels rewritten by hand for Hopper.  The package imports nothing of the
JAX package; its tests hold each module against its JAX counterpart.

Package layout (file names follow ``marlnav_tpu``):
  config.py    run configuration (the port's own copy)
  env/         environment core (dynamics, observations, rewards, auto-reset)
  models/      actor / critic ``nn.Module``s and the Gaussian policy
  algo/        MAPPO: rollout loop, returns, PPO losses, Adam update loops
  ops/         the fused collect, bench rollout, fused update and returns
               kernels (CUDA C++ under ops/csrc/) and their plain PyTorch
               versions; CUDA graphs that count their kernels' launches
  utils/       seeding, transforms, stats and weight files, checkpoints
  train.py     the training loop (blocks, graphed on the card, checkpoints
               and resume); __main__.py the CLI

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller asked for ``"cpu"``.
"""

import torch

# Full float32 matmuls: the collect kernel samples its whole trajectory
# through the actor operator composed by ops.fused_collect._affine_compose,
# which must be fp32-exact (TF32 keeps ~10 mantissa bits and would dominate
# every parity tolerance downstream).  Both switches are process-wide.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
