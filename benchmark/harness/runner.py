"""One run of one cell: set-up, the window (or the traced window), the
check, the result line.

The order is the contract's: set-up (counted in ``setup_s``), the window,
a look at ``sys.modules`` for JAX, the device's memory peak, the
program's state freed, then the reference over what the program produced,
which is not timed.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from benchmark.harness import spec
from benchmark.harness.trace import device_work

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was written from.
FORBIDDEN = ("jax", "jaxlib", "flax", "marlnav_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads: the traced window's device
    work, the host's spans a block, the units (repeats or calls) it ran,
    the cell's shapes; where the traffic's ``after_trace`` measured them,
    the collect kernel's seconds a launch (the profiler did not list it)
    and the check's own kernels and seconds a unit inside the traced
    work."""

    def __init__(self, work, spans, units, shapes):
        self.work, self.spans, self.units = work, spans, units
        self.shapes, self.collect_s = shapes, None
        self.harness_kernels, self.harness_s = 0, 0.0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             started: float, overrides: Optional[dict] = None,
             uniforms_fn: Optional[Callable] = None,
             check_kwargs: Optional[dict] = None,
             on_window_closed: Optional[Callable] = None,
             sizes: Optional[dict] = None) -> Dict:
    """Run ``name`` once; returns the result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` where traced) with
    the compared numbers under ``checks``.  ``started`` is the
    ``time.perf_counter()`` reading that stands for the process's start.
    ``uniforms_fn`` replaces the kernels' Philox uniforms in the check (a
    CPU run's plain collect draws its own).  ``sizes`` shrinks a cell for
    a test: ``{"traffic": {...}, "model": {...}}`` entries replace the
    traffic's and the model's."""
    from benchmark.reference import compare, philox

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.find_cell(name)
    if sizes:
        cell.traffic.update(sizes.get("traffic", {}))
        overrides = {**sizes.get("model", {}), **(overrides or {})}
    module = importlib.import_module(
        f"benchmark.harness.{cell.traffic['kind']}")
    traffic = module.Traffic(cell, seed, dev, overrides)
    on_card = dev.type == "cuda"
    nvcc = None
    if on_card:
        from marlnav_tpu_torch.ops._build import load_libraries

        torch.cuda.reset_peak_memory_stats(dev)
    traffic.setup()
    if on_card:
        nvcc = load_libraries.nvcc_runs
    t_window = time.perf_counter()
    setup_s = t_window - started
    metrics, device_info, breakdown, extra = {}, {}, None, {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        out = traffic.window(seconds)
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else out[m["name"]]
            metrics[m["name"]] = value
        attempted, failed = out["attempted"], out["failed"]
    else:
        prof, spans, n_units = traffic.traced(cell.cell["trace_units"],
                                              traffic.sync)
        attempted, failed = n_units, 0
        work = device_work(prof["prof"], prof["window_s"])
        ctx = Context(work, spans, n_units, traffic.shapes())
        if hasattr(traffic, "after_trace"):
            extra.update(traffic.after_trace(ctx, on_card))
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
        device_info.update(busy_s=work.busy_s, window_s=work.window_s)
        breakdown = {"device_ops": work.top(10),
                     "idle_gaps": work.idle_gaps[:10]}
    if on_window_closed is not None:
        on_window_closed()
    if on_card:
        device_info = dict(platform="gpu",
                           kind=torch.cuda.get_device_name(dev),
                           count=cell.chips,
                           memory_peak_bytes=int(
                               torch.cuda.max_memory_allocated(dev)),
                           **device_info)
    else:
        device_info = dict(platform=dev.type, kind=dev.type, count=1,
                           memory_peak_bytes=0, **device_info)
    t_check = time.perf_counter()
    keep = traffic.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with torch.no_grad():
        numbers = module.check(traffic, keep, uniforms_fn or philox.uniforms,
                               **(check_kwargs or {}))
    limits = cell.limits()
    correct = compare.verdict(numbers, limits)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed),
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["warm"] = {"nvcc_runs": nvcc, **extra}
    result["seconds"] = {"setup": setup_s, "window": t_check - t_window,
                         "check": time.perf_counter() - t_check,
                         **getattr(traffic, "setup_phases", {})}
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in limits}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(args, started: float) -> int:
    """The command line's run: exits 2, printing no result, without the
    card or cards the cell asks for, and 3 where a forbidden module was
    loaded."""
    cell = spec.find_cell(args.workload)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {count}", file=sys.stderr)
        return 2
    found = []

    def look():
        found.extend(forbidden_modules())

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started,
                      on_window_closed=look)
    if found:
        print(f"benchmark: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0

