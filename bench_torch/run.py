"""Run one benchmark cell once and print its result line (see README.md)::

    python3 -m bench_torch.run --workload poisson-saturne.still --seed 7 --seconds 30 --trace 0
"""

import time

# set-up is timed from here: the imports, the card, the build or load of
# the kernel library and the warm-up all count
T0 = time.perf_counter()

import sys  # noqa: E402

from bench_torch.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
