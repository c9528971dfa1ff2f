"""Run one cell of BENCHMARK.json once, on the CUDA card it is started on:

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the last lines of standard error give each number the run compared with
its limit.  See ``cellbench/harness.py``.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Import the benchmark as the package ``cellbench`` from the checkout's
# root, not its files as top-level modules from this directory.
sys.path[0] = ROOT

if __name__ == "__main__":
    from cellbench import harness

    sys.exit(harness.main(sys.argv[1:], start=START))
