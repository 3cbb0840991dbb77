"""python3 -m perfbench --workload NAME --seed N --seconds S --trace 0|1"""

import time

T0 = time.perf_counter()  # before torch and the program are imported: set-up starts here

import sys  # noqa: E402

from perfbench.harness import main  # noqa: E402

sys.exit(main(t0=T0))
