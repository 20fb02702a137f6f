"""CUDA graphs whose replays count as kernel launches.

A CUDA graph runs the kernels it captured each time it is replayed, but a
kernel wrapper's ``.launches`` counter moves only when the wrapper's Python
code runs: once, at capture, when nothing runs on the card.
``CountedGraph`` records what each counter gained during the capture, takes
it back, and adds it at every replay, so that the counters count what the
card ran: ``.launches`` and, where a wrapper has them,
``.pipelined_launches`` (``fused_update.critic_grad_sums``),
``.rt_launches`` (the run-time instances and route: the critic's, the
un-collapsed actor's and the collect's wrappers) and
``.rt_one_pass_launches`` (the route in one pass: the critic's and the
un-collapsed actor's).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

# The counters a kernel wrapper may carry; each is counted where present.
COUNTERS = ("launches", "pipelined_launches", "rt_launches",
            "rt_one_pass_launches")


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
        # (wrapper, counter, gain at capture)
        self._counted: List[Tuple[object, str, int]] = []

    @contextlib.contextmanager
    def capture(self):
        """Capture the work enqueued in the ``with`` body."""
        wrappers = kernel_wrappers()
        before = {(name, c): getattr(fn, c)
                  for name, fn in wrappers.items() for c in COUNTERS
                  if hasattr(fn, c)}
        try:
            with torch.cuda.graph(self.graph):
                yield self
        finally:
            gained = {key: getattr(wrappers[key[0]], key[1]) - n
                      for key, n in before.items()}
            for (name, c), n in before.items():
                setattr(wrappers[name], c, n)
            self.launches = {name: gained[(name, "launches")]
                             for name in wrappers}
            # The counters a replay adds to, resolved once here.
            self._counted = [(wrappers[name], c, n)
                             for (name, c), n in gained.items() if n]

    def replay(self) -> None:
        self.graph.replay()
        for fn, c, n in self._counted:
            setattr(fn, c, getattr(fn, c) + n)
