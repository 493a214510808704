"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository; see portbench/README.md.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
