"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA card(s) the
cell asks for (``BENCHMARK.json``).  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` runs the
cell's traced window under ``torch.profiler`` and reports its per-layer
metrics, the device's busy and window seconds, and a breakdown.  Either
way the run ends by checking what the program produced against the plain
reference under ``benchmark/reference/``; the last line of standard
output is one JSON object, and the last lines of standard error give each
compared number beside its limit.  Exits 2 (printing no result) without
the card(s), 3 where JAX or the JAX package was loaded.  The kernels'
libraries build into the checkout on the first run
(``marlnav_tpu_torch/ops/build/``).
"""

import argparse
import os
import sys
import time

_STARTED = time.perf_counter()


def _parser():
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.harness import runner

    # The process's age at _STARTED: the interpreter's own start counts.
    age = runner.process_age() - (time.perf_counter() - _STARTED)
    return runner.main(args, _STARTED - max(0.0, age))


if __name__ == "__main__":
    sys.exit(main())
