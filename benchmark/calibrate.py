"""Readings that set a cell's limits, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2]

Runs the cell as ``run.py`` does, with a short window, once a seed: the
program's sound runs (``--seeds``), then the control, the reference in
bfloat16 put in the program's place (``--control-seeds``). Prints one JSON
line a run: what ran, the seed, ``correct`` and each compared number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()

    import torch

    import control
    import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, control.ControlEntry) for s in args.control_seeds]
    for what, seed, wrap in runs:
        t0 = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False,
                                  t0, wrap_entry=wrap)
        print(json.dumps({"run": what, "seed": seed,
                          "correct": result["correct"],
                          "frames": result["attempted"],
                          "seconds": time.perf_counter() - t0,
                          **{k: v["value"]
                             for k, v in result["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
