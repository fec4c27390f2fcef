"""Running a cell of a tiny copy of the benchmark on the CPU, in process."""

from __future__ import annotations

import io
import json
import time

from benchmark.harness import runner


def run_cell(root: str, cell: str, seed: int = 3_000_000_007,
             trace: int = 0, seconds: float = 1.0):
  """(exit code, the result line or None, standard error)."""
  out, err = io.StringIO(), io.StringIO()
  rc = runner.main(['--workload', cell, '--seed', str(seed), '--seconds',
                    str(seconds), '--trace', str(trace)], time.perf_counter(),
                   root, device='cpu', require_chip=False, out=out, err=err)
  lines = out.getvalue().strip().splitlines()
  return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
