"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for.  Prints, as its last line of standard output, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error).  Exits non-zero and
prints no result without a card, with fewer cards than the cell asks
for, when JAX or the JAX package was loaded, or when a traced run finds
nothing for a per-layer metric that lists the cell.  ``--control 1``
judges the cell's control in the program's place instead (it has to
print ``"correct": false``); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the cell's control (the plain reference "
                    "in the precision below the configuration's) in the "
                    "program's place; it has to come out not correct")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.lib import harness
    harness.prepare_environment(ROOT)
    w = harness.workload(harness.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, root=ROOT,
                              control=bool(args.control))
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
