"""Profiling and debugging hooks.

Port of ``marlnav_tpu/utils/profiling.py``:

  * ``trace``        — a ``torch.profiler`` context writing a trace that
                       TensorBoard or Perfetto loads, for a code region;
  * ``annotate``     — a named sub-region inside a trace
                       (``torch.profiler.record_function``);
  * ``Throughput``   — a steps/s meter that waits for the device;
  * ``checked_step`` — wraps a function in the NaN and division-by-zero
                       guards of ``checkify.float_checks``: every operation
                       the function runs is checked, not only its output.

``checked_step`` reads the device when its error is read, so it stays
outside a CUDA graph.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace('/tmp/prof'): run()``, then load the
    ``*.pt.trace.json`` file written under ``log_dir`` in TensorBoard or
    Perfetto.  CPU activity always, the card's where CUDA is available;
    yields the ``torch.profiler.profile`` object."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named sub-region visible in the trace timeline."""
    return torch.profiler.record_function(name)


def _wait_for(result) -> None:
    """Wait until the device work behind ``result`` (a tensor or a tree of
    them) is done; nothing to wait for on the CPU."""
    for leaf in tree_leaves(result):
        if torch.is_tensor(leaf) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


class Throughput:
    """Wall-clock steps/s meter around device work.

    ``tick(n_steps, result)`` waits for ``result``'s device (so its work is
    actually finished) and accumulates; ``rate`` is aggregate steps/s.
    """

    def __init__(self) -> None:
        self.steps = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Throughput":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None

    def tick(self, n_steps: int, result=None) -> float:
        """Record ``n_steps`` finished when ``result`` is ready; returns the
        instantaneous rate."""
        if result is not None:
            _wait_for(result)
        now = time.perf_counter()
        dt = now - self._t0 if self._t0 is not None else 0.0
        self._t0 = now
        self.steps += n_steps
        self.seconds += dt
        return n_steps / dt if dt > 0 else float("inf")

    @property
    def rate(self) -> float:
        return self.steps / self.seconds if self.seconds > 0 else 0.0


class CheckError:
    """The error a ``checked_step`` call found, as ``checkify`` returns it:
    ``get()`` gives the first failed check's message or None, ``throw()``
    raises ``FloatingPointError`` with it."""

    def __init__(self, checks: List[Tuple[str, torch.Tensor]]):
        self._checks = checks  # (message, one bool on the op's device)

    def get(self) -> Optional[str]:
        for message, failed in self._checks:
            if bool(failed):
                return message
        return None

    def throw(self) -> None:
        message = self.get()
        if message is not None:
            raise FloatingPointError(message)


_aten = torch.ops.aten
# Operations whose divisor is checked for a zero, and the argument it is:
# jax's div_p (true and floor division alike) and ``1 / x``, which torch
# runs as a reciprocal.
_DIVISIONS = {_aten.div: 1, _aten.div_: 1, _aten.floor_divide: 1,
              _aten.floor_divide_: 1, _aten.reciprocal: 0,
              _aten.reciprocal_: 0}
# Operations that only move, select or bound values: a NaN they pass on was
# flagged where it was made (jax checks the primitives that can make one).
_PASS_THROUGH = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "t", "transpose", "slice", "select", "narrow", "as_strided", "unbind",
    "split", "split_with_sizes", "squeeze", "unsqueeze", "flip", "roll",
    "index", "index_select", "gather", "cat", "stack", "where", "clone",
    "copy", "copy_", "_to_copy", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "contiguous", "repeat", "repeat_interleave",
    "masked_fill", "index_put", "scatter", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "max", "min", "amax", "amin", "abs", "neg",
    "sign", "fill", "fill_", "zero_", "empty_like", "zeros_like",
    "ones_like", "full_like", "new_empty", "new_zeros", "new_full",
    "_local_scalar_dense"}


class _FloatChecks(TorchDispatchMode):
    """Records, for every operation run under it, whether its float output
    holds a NaN and whether a division's divisor holds a zero, as one bool
    each on the operation's device (no read of the device here).  An
    integer division by zero returns where torch would raise: its zero
    divisors are replaced by 1, the result marked failed."""

    def __init__(self):
        super().__init__()
        self.checks: List[Tuple[str, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _DIVISIONS:
            at = _DIVISIONS[packet]
            divisor = args[at]
            zero = (divisor == 0) if torch.is_tensor(divisor) \
                else torch.tensor(divisor == 0)
            self.checks.append((f"division by zero in {func}",
                                torch.any(zero)))
            if torch.is_tensor(divisor) and not divisor.is_floating_point():
                args = list(args)
                args[at] = torch.where(zero, torch.ones_like(divisor),
                                       divisor)
            elif not torch.is_tensor(divisor) and divisor == 0 \
                    and isinstance(divisor, int):
                args = list(args)
                args[at] = 1
        out = func(*args, **kwargs)
        if packet.__name__ not in _PASS_THROUGH:
            for leaf in tree_leaves(out):
                if torch.is_tensor(leaf) and leaf.is_floating_point():
                    self.checks.append((f"nan generated by {func}",
                                        torch.any(torch.isnan(leaf))))
        return out


def checked_step(step_fn: Callable) -> Callable:
    """Wrap ``step_fn`` in the guards of ``checkify.float_checks``: a NaN
    made by any operation (also one a later ``where`` masks) and a division
    by a divisor holding a zero (float or integer); an ``inf`` from an
    overflow passes.  Returns ``guarded(*args, **kwargs) -> (err, out)``;
    call ``err.throw()`` (or ``err.get()``) to read it.

    Usage::

        guarded = checked_step(env.step)
        err, (state, out) = guarded(state, actions)
        err.throw()
    """

    def guarded(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = step_fn(*args, **kwargs)
        return CheckError(mode.checks), out

    return guarded
