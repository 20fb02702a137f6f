"""Seeding and device selection.

The reference seeds four global RNGs (reference utils.py:550-559).  The
port uses no global RNG: every random draw takes an explicit
``torch.Generator`` built here from the run's seed.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: str) -> torch.device:
    """The device an entry point runs on.  Raises when CUDA is asked for
    (the default) but absent, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass --device cpu (device='cpu') to run on the CPU")
    return dev


def make_generator(seed: Optional[int], device="cpu") -> torch.Generator:
    """Generator on ``device`` seeded from an optional seed (None -> 0)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(0 if seed is None else int(seed))
    return g
