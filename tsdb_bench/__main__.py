"""`python -m tsdb_bench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`: one run of one cell (run.py)."""

import time

T_START = time.monotonic()

import sys  # noqa: E402

from .run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
