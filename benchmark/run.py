"""Run one cell of the port's benchmark once, from the checkout's root:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result, one JSON object; the
numbers compared for ``correct`` and their limits close standard error.
See harness/main.py and PERF.md."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
