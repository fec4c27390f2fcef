"""One run of one cell: `python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`.

It finds the cell's files by name (`spec.py`), refuses to run without the
cards the cell asks for, runs the cell's entry (`entries/<entry>.py`),
which makes the inputs and weights from the seed, warms up, measures for
`--seconds` seconds and then checks what the timed path produced against
the plain reference, and prints one JSON line: the end-to-end metrics
with `--trace 0`, the per-layer metrics with `--trace 1`. The numbers the
check compared come last in the line and, each beside its limit, as the
last lines on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from benchmark.harness import imports, spec


@dataclasses.dataclass
class Check:
  """One number the correctness check compared, and its limit."""
  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
  """What an entry hands back."""
  end_to_end: Dict[str, float]
  record: Dict[str, Any]
  checks: List[Check]
  attempted: int
  failed: int
  peak_bytes: int


@dataclasses.dataclass
class Context:
  cell: spec.Cell
  seed: int
  seconds: float
  trace: bool
  device: Any
  t_start: float
  tmpdir: str
  log: Any = sys.stderr

  def say(self, *parts):
    print('[bench]', *parts, file=self.log, flush=True)


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def _check_program(code_root: str) -> Optional[str]:
  """Imports the program; why it cannot run from this checkout, or None."""
  try:
    import mulan_tpu_torch
  except ImportError as e:
    return f'the program does not import: {e}'
  where = os.path.realpath(os.path.dirname(mulan_tpu_torch.__file__))
  if not where.startswith(os.path.realpath(code_root) + os.sep):
    return f'the program was loaded from {where}, outside the checkout'
  return None


def metrics_line(cell: spec.Cell, outcome: Outcome, trace: bool
                 ) -> Tuple[Dict[str, Dict[str, Any]], List[str]]:
  """The line's metrics and the names of those the cell should have
  reported and did not read."""
  out, missing = {}, []
  if trace:
    for m in cell.per_layer:
      value = cell.metric_reader(m['name']).read(outcome.record)
      if value is None:
        if 'workloads' in m:
          missing.append(m['name'])
        continue
      out[m['name']] = {'value': float(value), 'unit': m['unit']}
  else:
    for m in cell.end_to_end:
      if m['name'] not in outcome.end_to_end:
        missing.append(m['name'])
        continue
      out[m['name']] = {'value': float(outcome.end_to_end[m['name']]),
                        'unit': m['unit']}
  return out, missing


def main(argv, t_start: float, root: str, *, device=None,
         require_chip: bool = True, out=None, err=None) -> int:
  """Runs a cell from the definitions under `root`; prints the result line
  to `out` and returns the exit code. Tests pass a `device` and
  `require_chip=False`."""
  out = out or sys.stdout
  err = err or sys.stderr
  args = parse(argv)
  cell = spec.load_cell(root, args.workload)
  import torch
  if require_chip:
    from benchmark.harness import device as device_lib
    why = device_lib.missing_chips(cell.chips)
    if why:
      print(f'[bench] no run: {why}', file=err)
      return 3
    device = torch.device('cuda', 0)
  code_root = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  why = _check_program(code_root)
  if why:
    print(f'[bench] no run: {why}', file=err)
    return 5
  bad = imports.loaded_forbidden()
  if bad:
    print(f'[bench] forbidden modules loaded at start: {bad}', file=err)
    return 4
  tmpdir = tempfile.mkdtemp(prefix='mulan-bench-')
  try:
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device(device), t_start, tmpdir, err)
    outcome = cell.entry_module().run(ctx)
  finally:
    shutil.rmtree(tmpdir, ignore_errors=True)
  bad = imports.loaded_forbidden()
  if bad:
    print(f'[bench] forbidden modules loaded after the window: {bad}',
          file=err)
    return 4
  metrics, missing = metrics_line(cell, outcome, ctx.trace)
  if missing:
    print(f'[bench] metrics not read: {missing}', file=err)
  from benchmark.harness import device as device_lib
  dev = device_lib.describe(ctx.device, cell.chips, outcome.peak_bytes)
  correct = (outcome.attempted > 0 and outcome.failed == 0
             and all(c.ok for c in outcome.checks))
  line = {'correct': correct, 'attempted': outcome.attempted,
          'failed': outcome.failed, 'metrics': metrics, 'device': dev}
  if ctx.trace:
    traced = outcome.record.get('trace') or {}
    print('[trace] device seconds by category:',
          json.dumps(traced.get('by_category_s')), file=err)
    dev['busy_s'] = traced.get('busy_s')
    dev['window_s'] = traced.get('window_s')
    if 'breakdown' in traced:
      line['breakdown'] = traced['breakdown']
  line['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                    for c in outcome.checks}
  for c in outcome.checks:
    print(f'[check] {c.name} {c.value!r} limit {c.limit!r} '
          f'{"ok" if c.ok else "FAILED"}', file=err)
  err.flush()
  print(json.dumps(line), file=out, flush=True)
  return 0
