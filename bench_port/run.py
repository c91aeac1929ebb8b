"""Runs one cell of the port's benchmark once, on the card of this machine:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root.  The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the
correctness check compared, each beside its limit.  See harness.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run())
