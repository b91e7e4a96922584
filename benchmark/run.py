#!/usr/bin/env python3
"""Benchmark of vlgp_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of its
standard output (see harness.py)."""
import time

STARTED = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
