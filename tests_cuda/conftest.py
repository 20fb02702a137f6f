"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests import nothing of ``jax`` or ``marlnav_tpu``: they run wherever
the port runs.  From the root of the repository, on a machine with an
NVIDIA GPU and ``nvcc``:

    python -m pytest tests_cuda -q

``chip_smoke.py`` runs them so.  Every test takes the ``cuda`` fixture and
skips where ``torch.cuda.is_available()`` is False.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU "
        "mode); skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")
