"""The traced window: ``torch.profiler`` over it, then the device's work by
kernel, its busy time and its longest idle gaps.

Busy time is the union of the device intervals of kernels, copies and
sets (the profiler's own annotations left out), so overlapping work is
counted once.  An idle gap is named by the innermost host operation that
was running when it began: the harness's own ranges (``bench.*``) or the
program's."""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class DeviceWork:
    """What the profiler saw on the device in the traced window."""

    table: List[Tuple[str, int, float]]  # (name, count, seconds)
    busy_s: float
    window_s: float
    idle_gaps: List[Tuple[str, float]]

    def kernels(self, *parts: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds every one
        of ``parts``."""
        rows = [(c, s) for n, c, s in self.table
                if all(p in n for p in parts)]
        return sum(c for c, _ in rows), sum(s for _, s in rows)

    def top(self, n: int = 10) -> List[List]:
        return [[name, s] for name, _, s in
                sorted(self.table, key=lambda r: -r[2])[:n]]


@contextlib.contextmanager
def traced(sync):
    """Profile the ``with`` body; yields a dict that holds, after it, the
    profiler (``prof``) and the window's wall seconds (``window_s``),
    from the first enqueue to the final ``sync()``."""
    from torch.profiler import ProfilerActivity, profile

    kwargs = {}
    if "acc_events" in inspect.signature(profile).parameters:
        kwargs["acc_events"] = True
    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kwargs) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def device_work(prof, window_s: float, n_gaps: int = 10) -> DeviceWork:
    """Read the profiler of a traced window."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in host_names]
    by_name: Dict[str, List[float]] = {}
    for e in on_device:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) * 1e-6
    table = [(n, c, s) for n, (c, s) in by_name.items()]
    merged = _union([(e.time_range.start, e.time_range.end)
                     for e in on_device])
    busy_s = sum(end - start for start, end in merged) * 1e-6
    host = [e for e in events if e.device_type == DeviceType.CPU]
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gaps.append((start - end, end))
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:n_gaps]:
        inner: Optional[object] = None
        for e in host:
            if e.time_range.start <= at <= e.time_range.end and (
                    inner is None or e.time_range.start
                    >= inner.time_range.start):
                inner = e
        named.append([inner.name if inner is not None else "host idle",
                      length * 1e-6])
    return DeviceWork(table, busy_s, window_s, named)
