"""CUDA graphs whose replays count as kernel launches.

A CUDA graph runs the kernels it captured each time it is replayed, but a
kernel wrapper's ``.launches`` counter moves only when the wrapper's Python
code runs: once, at capture, when nothing runs on the card.
``CountedGraph`` records what each counter gained during the capture, takes
it back, and adds it at every replay, so that the counters count what the
card ran.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def kernel_wrappers() -> Dict[str, object]:
    """The wrapper of each of the port's CUDA kernels, by name; each counts
    its launches in ``.launches``."""
    from marlnav_tpu_torch.ops import (fused_collect, fused_rollout,
                                       fused_update, returns)

    return {"fused_collect": fused_collect.fused_collect_rows,
            "fused_actor_grad": fused_update.actor_grad_sums,
            "fused_critic_grad": fused_update.critic_grad_sums,
            "fused_actor_grad_uncollapsed":
                fused_update.actor_grad_uncollapsed_sums,
            "fused_rollout": fused_rollout.fused_rollout_rows,
            "returns": returns.returns_scan}


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays add to the kernels'
    launch counters.  ``generators`` are CUDA generators the captured work
    draws from: registered with the graph, each advances across replays as
    it would across the same work run eagerly."""

    def __init__(self, generators=()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.launches: Dict[str, int] = {}

    @contextlib.contextmanager
    def capture(self):
        """Capture the work enqueued in the ``with`` body."""
        wrappers = kernel_wrappers()
        before = {name: fn.launches for name, fn in wrappers.items()}
        try:
            with torch.cuda.graph(self.graph):
                yield self
        finally:
            self.launches = {name: fn.launches - before[name]
                             for name, fn in wrappers.items()}
            for name, fn in wrappers.items():
                fn.launches = before[name]

    def replay(self) -> None:
        self.graph.replay()
        for name, fn in kernel_wrappers().items():
            fn.launches += self.launches.get(name, 0)
