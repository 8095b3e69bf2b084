#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... [--faulted 3] [--out f.jsonl]

For every seed, the program's first steps against the float32 reference:
the lower readings.  For the first ``--faulted`` seeds also the upper ones:
the control (the reference computed in float8 put in the program's place)
and two planted faults, each in the reference put in the program's place:
half of each batch left out, the mean taken over the rest; a step that
returns its state unchanged (which reads 1 on ``grad_gap`` and
``change_gap`` by their definitions).  The benchmark's own runs do not run
this.

Prints one JSON line per reading, then a summary: each number's largest
sound reading and smallest control and fault readings.  Runs on the first
CUDA device, or on the CPU with ``--device cpu`` (tests, tiny cells).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import harness  # noqa: E402


def readings(cell, seeds, faulted: int, device: str, emit=print) -> dict:
    """Run the calibration of ``cell``; returns the summary."""
    import torch

    from tpudra_torch.workload import model

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    ref = harness.reference(cell)
    by_kind: dict = {}
    for i, seed in enumerate(seeds):
        _, loop, prog, _ = harness.setup(cell, ref, model, seed, dev)
        batches = [loop.pool[j].clone() for j in range(harness.CHECK_STEPS)]
        del loop
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        want = harness.reference_readings(cell, ref, seed, batches, dev)
        sides = [("program", prog)]
        if i < faulted:
            half = slice(0, cell.traffic["batch"] // 2)
            sides += [("control", harness.reference_readings(cell, ref, seed, batches, dev, "fp8")),
                      ("half_batch", harness.reference_readings(cell, ref, seed, batches, dev,
                                                                rows=half)),
                      ("unchanged", harness.reference_readings(cell, ref, seed, batches, dev,
                                                               frozen=True))]
        for kind, got in sides:
            numbers, leaf = harness.compare(got, want)
            by_kind.setdefault(kind, []).append(numbers)
            emit(json.dumps({"workload": cell.name, "seed": seed, "kind": kind, **numbers,
                             "leaf_gaps": leaf, "losses": got["losses"],
                             "reference_losses": want["losses"]}))
    names = list(by_kind["program"][0])
    summary = {"workload": cell.name, "seeds": len(seeds), "faulted": faulted,
               "lower": {n: max(r[n] for r in by_kind["program"]) for n in names}}
    for kind in ("control", "half_batch", "unchanged"):
        if kind in by_kind:
            summary[kind] = {n: min(r[n] for r in by_kind[kind]) for n in names}
    emit(json.dumps({"summary": summary}))
    return summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--faulted", type=int, default=3)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args()
    cell = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, [int(s) for s in args.seeds.split(",")], args.faulted, args.device, emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
