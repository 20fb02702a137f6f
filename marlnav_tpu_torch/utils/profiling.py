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

Beyond the JAX package's hooks, what a trace of a CUDA graph cannot show:

  * ``annotate``     — also sums each range's host time and count by name
                       while a ``torch.profiler`` session records
                       (``span_summary``);
  * ``phase``        — a phase of a training block (``marlnav.<name>``):
                       an ``annotate`` range on the host and, inside an
                       open ``phase_block`` on the card, a device stamp at
                       its entry and its exit.  Python runs only at a
                       graph's capture, so a host range is never seen at a
                       replay; a stamp is a kernel node of the graph, run
                       at every replay;
  * ``phase_ms``     — device milliseconds of each phase a repeat in the
                       latest block: a graph's latest replay
                       (``replayed``) or the latest eager block;
  * ``set_phase_marks`` — marks on (the default) or off, read when a block
                       opens, so a graph keeps what its capture saw.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

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


# name -> [count, host nanoseconds] of the ``annotate`` ranges run while a
# profiler recorded.
_spans: Dict[str, List[int]] = {}


class _Range(contextlib.ContextDecorator):
    """``record_function(name)`` that, while a profiler records, adds its
    host time to ``_spans``; otherwise it costs one check more."""

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)
        self.t0 = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.t0 = time.perf_counter_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        if self.t0 is not None:
            entry = _spans.setdefault(self.name, [0, 0])
            entry[0] += 1
            entry[1] += time.perf_counter_ns() - self.t0
            self.t0 = None
        return False


def annotate(name: str):
    """Named sub-region visible in the trace timeline; while a profiler
    records, its host time also adds to ``span_summary()``."""
    return _Range(name)


def span_summary() -> Dict[str, Dict[str, float]]:
    """``{name: {"count": n, "ms": host milliseconds}}`` summed over the
    ``annotate`` ranges that ran while a ``torch.profiler`` session
    recorded, in this process."""
    return {name: {"count": n, "ms": ns * 1e-6}
            for name, (n, ns) in _spans.items()}


# ---------------------------------------------------------------------------
# Phase marks


class PhaseMarks:
    """The device stamps of one block's phase marks: for each time a mark
    ran in the block, an int64 pair that the stamp kernel fills with the
    global timer (ns) at the mark's entry and exit.  A captured graph's
    marks are made at its capture and rewritten by every replay; eager
    blocks share one set, which grows to the largest block and is reused."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pairs: Dict[str, List[torch.Tensor]] = {}
        self.ran: Dict[str, int] = {}

    def take(self, name: str) -> torch.Tensor:
        """The pair of the mark's next run in the block.  ``empty``: under
        capture a fill would be a node of the graph."""
        i = self.ran.get(name, 0)
        self.ran[name] = i + 1
        pairs = self.pairs.setdefault(name, [])
        if i == len(pairs):
            pairs.append(torch.empty(2, dtype=torch.int64,
                                     device=self.device))
        return pairs[i]

    def read(self) -> Tuple[Dict[str, float], float]:
        """``({mark: ms a repeat}, ms a repeat from the first stamp to the
        last)`` of the block's latest run, which it waits for; a block's
        repeats are the most runs of any one mark in it."""
        names = [n for n, k in self.ran.items() if k]
        if not names:
            return {}, 0.0
        stamps = torch.stack([p for n in names
                              for p in self.pairs[n][:self.ran[n]]]).cpu()
        repeats = max(self.ran.values())
        out, at = {}, 0
        for n in names:
            k = self.ran[n]
            spans = stamps[at:at + k]
            out[n] = float((spans[:, 1] - spans[:, 0]).sum()) * 1e-6 / repeats
            at += k
        wall = float(stamps[:, 1].max() - stamps[:, 0].min()) * 1e-6
        return out, wall / repeats


_phase_marks = True  # read when a block opens (set_phase_marks)
_open: Optional[PhaseMarks] = None  # the block phase() stamps into
_eager: Optional[PhaseMarks] = None  # the eager blocks' marks, reused
_latest: Optional[PhaseMarks] = None  # the block phase_ms() reads


def set_phase_marks(on: bool) -> None:
    """Capture phase marks (the default) or leave them out; read when a
    block opens, so a graph keeps what its capture saw."""
    global _phase_marks
    _phase_marks = bool(on)


@functools.lru_cache(maxsize=None)
def _stamp_library():
    from marlnav_tpu_torch.ops._build import load_library

    lib, _ = load_library("phase_stamp")
    lib.marlnav_phase_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.marlnav_phase_stamp.restype = ctypes.c_int
    return lib


def _stamp(pair: torch.Tensor, k: int) -> None:
    """Launch the stamp kernel into ``pair[k]`` on the current stream."""
    device = pair.device
    err = _stamp_library().marlnav_phase_stamp(
        pair.data_ptr() + k * pair.element_size(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase stamp launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _loaded(index: Optional[int]) -> None:
    """Build, load and run the stamp kernel once on card ``index`` (None:
    the current one), so that a capture that follows loads nothing."""
    device = torch.device("cuda", index)
    _stamp(torch.empty(2, dtype=torch.int64, device=device), 0)


@contextlib.contextmanager
def phase_block(device, captured: bool = False):
    """Open one block of phase marks on ``device`` for the ``with`` body
    and yield its ``PhaseMarks``, or None: off the card, with marks off,
    or inside a block already open (which keeps the stamps).  Enter it
    before a capture with ``captured``: the marks are then the graph's
    own, new, and become the latest at each ``replayed(marks)``; an eager
    block's become the latest when it ends."""
    global _open, _eager, _latest
    device = torch.device(device)
    if _open is not None or device.type != "cuda":
        yield None
        return
    if not _phase_marks:
        yield None
        if not captured:
            _latest = None
        return
    _loaded(device.index)
    if captured:
        marks = PhaseMarks(device)
    else:
        if _eager is None or _eager.device != device:
            _eager = PhaseMarks(device)
        marks = _eager
        marks.ran.clear()
    _open = marks
    try:
        yield marks
    finally:
        _open = None
    if not captured:
        _latest = marks


def replayed(marks: Optional[PhaseMarks]) -> None:
    """A graph whose capture made ``marks`` (None: none) was replayed."""
    global _latest
    _latest = marks


@contextlib.contextmanager
def phase(name: str):
    """The phase ``name`` of a block: the range ``marlnav.<name>`` on the
    host and, in an open ``phase_block``, device stamps at its entry and
    exit (on the current stream)."""
    with annotate("marlnav." + name):
        marks = _open
        if marks is None:
            yield
            return
        pair = marks.take(name)
        _stamp(pair, 0)
        yield
        _stamp(pair, 1)


def phase_ms() -> Dict[str, float]:
    """Device milliseconds of each phase a repeat in the latest block (a
    graph's latest replay, or the latest eager block), read from its stamps
    now, after waiting for them; ``{}`` where no block ran with marks (on
    the CPU, or with marks off)."""
    if _latest is None:
        return {}
    return _latest.read()[0]


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
