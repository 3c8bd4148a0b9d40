"""Run one cell of the benchmark on this machine's NVIDIA GPU:

    python3 vpfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the cell's metrics as the last line
of standard output (one JSON object) and each correctness number beside
its limit as the last lines of standard error. Exits non-zero, with no
result, without a CUDA device or with fewer than the cell asks for.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from vpfbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
