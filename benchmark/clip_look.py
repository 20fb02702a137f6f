"""The look at a train cell's phases: where the program, the float64
reference and the same reference in float32 part, and how many rows lie
on another side of the phase's clip (the ratio's, the value's) when they
do.

    python3 benchmark/clip_look.py --workload default.train \
        --seeds 1,2,3 [--out FILE]

For each seed: the cell's set-up (its first graphed block), then for
each compared repeat the reference from the program's state at its
start, once in float64 (as the check) and once in float32.  Prints one
JSON line a repeat, with for each phase: the step at which each pair's
losses first differ by more than ``--part`` (relative, as ``compare``
measures them), the gaps of the losses and of the worst and median leaf
for each pair, and at each step the rows whose side of the clip differs
between the float32 and the float64 reference, and the rows of the
float64 reference that changed side since the step before.  Needs the
card.
"""

import argparse
import json
import os
import sys


def _first_part(gaps, part):
    over = [i for i, g in enumerate(gaps) if g > part]
    return over[0] if over else None


def look(name: str, seed: int, part: float, device="cuda", sizes=None,
         uniforms_fn=None):
    """The look's lines for one seed (``sizes`` and ``uniforms_fn`` as
    ``runner.run_cell`` takes them, for a run on the CPU)."""
    import statistics

    import torch

    from benchmark.harness import train
    from benchmark.reference import compare, philox

    traffic, keep = train.set_up(name, seed, device, sizes)
    n = traffic.n_losses
    lines = []
    with torch.no_grad():
        for i, kseed, start, end in train.compared_repeats(traffic, keep):
            sides, refs = {}, {}
            for label, dtype in (("f64", torch.float64),
                                 ("f32", torch.float32)):
                sides[label] = {"actor": [], "critic": []}
                refs[label] = train.reference_repeat(
                    traffic, start, kseed, uniforms_fn or philox.uniforms,
                    dtype=dtype, sides=sides[label])
            row = torch.as_tensor(keep["rows"][i], dtype=torch.float64)
            line = {"seed": seed, "repeat": i}
            for phase, at in (("actor", 4), ("critic", 4 + n)):
                losses = {"program": row[at:at + n],
                          "f64": refs["f64"][phase + "_losses"].cpu().double(),
                          "f32": refs["f32"][phase + "_losses"].cpu().double()}
                scale = torch.clamp_min(
                    losses["f64"].abs(),
                    float(torch.median(losses["f64"].abs())))
                pairs = {}
                for a, b, end_a in (("program", "f64", end),
                                    ("f32", "f64", refs["f32"]),
                                    ("program", "f32", end)):
                    gaps = (torch.abs(losses[a] - losses[b])
                            / scale).tolist()
                    leaves = compare.leaf_gaps(start, end_a, refs[b], phase)
                    pairs[f"{a}_vs_{b}"] = {
                        "parts_at_step": _first_part(gaps, part),
                        "loss_gap_first_10": max(
                            gaps[:compare.STEADY_STEPS]),
                        "loss_gap_all_steps": max(gaps),
                        "worst_leaf": max(leaves),
                        "median_leaf": statistics.median(leaves)}
                s64, s32 = sides["f64"][phase], sides["f32"][phase]
                line[phase] = {
                    "pairs": pairs, "rows": int(s64[0].numel()),
                    "clipped_f64": [int((s != 0).sum()) for s in s64],
                    "sides_differ_f32_f64": [int((a != b).sum())
                                             for a, b in zip(s32, s64)],
                    "changed_side_f64": [0] + [
                        int((a != b).sum()) for a, b in zip(s64, s64[1:])]}
            lines.append(line)
            del refs, sides
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/clip_look.py")
    ap.add_argument("--workload", default="default.train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--part", type=float, default=1e-5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("clip_look: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for seed in (int(s) for s in args.seeds.split(",") if s):
        for line in look(args.workload, seed, args.part):
            out.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
