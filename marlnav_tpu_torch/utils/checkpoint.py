"""Checkpoints of the full training state, with resume.

Port of ``marlnav_tpu/utils/checkpoint.py`` on ``torch.save`` (no orbax).
The reference saves network weights only, with no resume path (reference
models.py:127-129).  Here a checkpoint holds the whole training state (the
tree ``train.checkpoint_tree`` builds: both networks and Adam states, the
env state, the generator's state) with the repeat index and the stats
logger's host state, and ``restore`` resumes training where it stopped.

Each checkpoint is one file, ``ckpt_<step>.pt``, written to a temporary
file in the same directory and moved into place with ``os.replace``: a
reader never sees half a checkpoint.  The ``max_to_keep`` latest steps are
kept.  Under a data-parallel mesh only rank 0 writes; every rank reads
the same files on resume.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Saves and restores a tree of tensors plus a host dict, one file a
    step, under ``directory``; ``save_interval`` gates ``save`` by step."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval: int = 1, writes: bool = True):
        if max_to_keep < 1 or save_interval < 1:
            raise ValueError(f"need max_to_keep, save_interval >= 1, got "
                             f"{max_to_keep}, {save_interval}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        # writes=False (a data-parallel rank other than 0) only reads.
        self.writes = writes
        if writes:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        """The saved steps, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, tree: Any, host_state: Optional[dict] = None,
             force: bool = False) -> bool:
        """Save ``tree`` and ``host_state`` as ``step`` when ``step`` is a
        multiple of ``save_interval`` or ``force``; ``False`` when not
        saved, also for a step that is already saved."""
        if not self.writes or (not force and step % self.save_interval != 0):
            return False
        if step in self.all_steps():
            return False
        tmp = os.path.join(self.directory, f".ckpt_{step}.pt.{os.getpid()}")
        try:
            torch.save({"step": step, "tree": tree, "host": host_state}, tmp)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Any, Optional[dict]]:
        """``(step, tree, host_state)`` of ``step`` (default: the latest),
        with every tensor on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return saved["step"], saved["tree"], saved["host"]

    def close(self) -> None:
        """Nothing is left in flight: each save has finished when it
        returns."""
