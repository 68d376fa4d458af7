"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs on the CUDA card of the machine it is started on and exits non-zero,
printing no result, without one (or with fewer than the cell asks for).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also end standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
# Python's bytecode of every module the run imports (torch's, the port's,
# the benchmark's) is cached in the checkout, so that only its first run
# compiles it, whatever the environment says of writing bytecode.
sys.pycache_prefix = str(HERE.parent / "build" / "pycache")
sys.dont_write_bytecode = False
# The extension's build directory lies in the checkout; torch's own caches
# (a kernel cache, a JIT cache) are kept there too, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(HERE.parent / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(HERE.parent / "build" / "triton_cache"))
os.environ["USE_FLAX"] = "0"
# One process with few threads: the host's thread pools (OpenMP, BLAS) get
# one thread each, so the run's host work does not contend with itself.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness

    _, cell, *_ = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, the machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"loaded by the run: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
