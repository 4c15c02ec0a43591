"""One run of one benchmark cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up, then the measured window of ``--seconds``, then the comparison
with the plain reference; the last line of standard output is the result
(`bench/harness.py`). Run from the root of a checkout of the repository.
"""

import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
