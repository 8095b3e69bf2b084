#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the correctness numbers beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output.  Exits non-zero, with no result, where there is no
CUDA device or fewer than the cell asks for, where a file of the benchmark
or the program is missing, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Import the benchmark and the program from the checkout, not this folder.
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there compiles.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "perfbench" / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "perfbench" / ".cache" / "torch_extensions")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    from perfbench import harness

    try:
        cell = harness.load_cell(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise harness.RunError(f"the cell needs {cell.chips} CUDA device(s), {n} visible")
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                          log=lambda m: print(m, file=sys.stderr, flush=True))
    except harness.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
