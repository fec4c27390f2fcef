"""Runs one cell of the benchmark of `mulan_tpu_torch` on the card(s) of
this machine and prints its result as one JSON line.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cells, configurations and metrics are in `BENCHMARK.json` at the root
of the checkout and in the files under `benchmark/` (`harness/spec.py`).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == '__main__':
  sys.path.insert(0, ROOT)
  from benchmark.harness import runner
  sys.exit(runner.main(sys.argv[1:], T_START, ROOT))
