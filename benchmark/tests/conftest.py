"""The benchmark's own tests.  On the CPU (the port's plain versions at
toy sizes):

    python -m pytest benchmark/tests -q

On a machine with the card the tests marked ``cuda`` run too; elsewhere
they skip (the ``cuda`` fixture decides, never an import)."""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def cpu_uniforms():
    """The uniforms the port's plain collect and rollout draw on the CPU
    for a kernel seed (its generator, not the kernels' Philox)."""
    from marlnav_tpu_torch.utils.seeding import make_generator

    def draw(seed, envs, steps, n_draws, device):
        return torch.rand((steps, n_draws, envs),
                          generator=make_generator(int(seed), "cpu"))

    return draw
