#!/usr/bin/env python3
"""The benchmark of `pvderx_torch` on NVIDIA H100 cards: one cell per run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout that holds `BENCHMARK.json`, this
directory and the `pvderx_torch` package, on a machine with the CUDA cards
the cell asks for; exits non-zero, printing no result, without them. See
`portbench/harness.py` for what a run does and prints.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root, in place of this directory, on the module path
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
