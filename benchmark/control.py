"""Readings that set a cell's limits for ``correct``: the sound program on
many seeds, and the control on a few, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--seconds 2] \
        [--out FILE]

The control is the program's own lower-precision path where it has one
(the train cells: ``bf16_updates``, the gradient kernels' bf16 operands),
else the reference computed with its actor's operands rounded to bfloat16
(the rollout cell).  Each run is ``benchmark/run.py``'s run at the cell's
own size with a short window; each prints one JSON line of its compared
numbers.  A limit lies between the largest sound reading and the smallest
control reading (``PERF.md`` gives both).

``--fault-seeds`` (train cells) reads the faults a training step can
have with the reference put in the program's place: from each compared
repeat's start the reference runs once sound and once with the fault
planted (Adam's step doing nothing; half of the batch left out and the
mean taken over the rest), and the faulty run is compared as the
program's would be.  Needs the card.
"""

import argparse
import contextlib
import json
import os
import sys
import time


def _rounding_bf16(x):
    import torch

    return x.to(torch.bfloat16).to(torch.float32)


FAULTS = ("state_unchanged", "half_batch")


def _half(fn, first: int, count: int):
    def run(w, *args, **kw):
        args = list(args)
        n = args[first].shape[0] // 2
        for i in range(first, first + count):
            args[i] = args[i][:n]
        return fn(w, *args, **kw)
    return run


@contextlib.contextmanager
def planted(fault: str):
    """The reference with ``fault`` planted, inside the ``with``."""
    from benchmark.reference import mappo

    saved = (mappo.Adam.step, mappo.actor_loss, mappo.critic_loss)
    if fault == "state_unchanged":
        mappo.Adam.step = lambda self, grads: None
    else:
        mappo.actor_loss = _half(mappo.actor_loss, 0, 4)
        mappo.critic_loss = _half(mappo.critic_loss, 0, 3)
    try:
        yield
    finally:
        mappo.Adam.step, mappo.actor_loss, mappo.critic_loss = saved


def _as_program(ref: dict):
    """A reference repeat's outputs as the program's: its block row and
    its state at the end."""
    import torch

    row = torch.cat([torch.stack([torch.as_tensor(float(ref["mean_rew"]))]),
                     ref["counts"].cpu().double(),
                     ref["actor_losses"].cpu().double(),
                     ref["critic_losses"].cpu().double()])
    state = {"rows": ref["rows"]}
    for net in ("actor", "critic"):
        state[net] = ref[net]
        adam = ref["adam"][net]
        state[net + "_m"] = {k: m for k, (m, _, _) in adam.items()}
        state[net + "_v"] = {k: v for k, (_, v, _) in adam.items()}
        state[net + "_t"] = {k: torch.tensor(t) for k, (_, _, t) in
                             adam.items()}
    return row, state


def fault_readings(name: str, seed: int, device="cuda", sizes=None,
                   uniforms_fn=None) -> dict:
    """``{fault: compared numbers}`` of the reference with each fault
    planted, against the sound reference, over the compared repeats."""
    import torch

    from benchmark.harness import train
    from benchmark.reference import compare, philox

    uniforms_fn = uniforms_fn or philox.uniforms
    traffic, keep = train.set_up(name, seed, device, sizes)
    out = {f: [] for f in FAULTS}
    with torch.no_grad():
        for _, kseed, start, _ in train.compared_repeats(traffic, keep):
            ref = train.reference_repeat(traffic, start, kseed, uniforms_fn)
            for fault in FAULTS:
                with planted(fault):
                    bad = train.reference_repeat(traffic, start, kseed,
                                                 uniforms_fn)
                row, end = _as_program(bad)
                out[fault].append(compare.train_numbers(
                    row, start, end, ref, traffic.n_losses))
    return {f: compare.worst(v) for f, v in out.items()}


def control_kwargs(kind: str):
    """``run_cell``'s arguments that make the control of a cell of
    ``kind``."""
    if kind == "train":
        return {"overrides": {"bf16_updates": True}}
    return {"check_kwargs": {"rounding": _rounding_bf16}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    from benchmark.harness import runner, spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    kind = spec.find_cell(args.workload).traffic["kind"]
    lines = []
    for label, seeds, kwargs in (
            ("sound", args.seeds, {}),
            ("control", args.control_seeds, control_kwargs(kind))):
        for seed in (int(s) for s in seeds.split(",") if s):
            result = runner.run_cell(args.workload, seed, args.seconds,
                                     False, "cuda", time.perf_counter(),
                                     **kwargs)
            line = {"run": label, "seed": seed,
                    "correct": result["correct"],
                    "numbers": {k: c["value"]
                                for k, c in result["checks"].items()},
                    "readings": result["readings"]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    for seed in (int(s) for s in args.fault_seeds.split(",") if s):
        for fault, numbers in fault_readings(args.workload, seed).items():
            line = {"run": fault, "seed": seed, "numbers": numbers}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(lines, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
