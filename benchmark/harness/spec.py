"""The benchmark's definitions, found by name in files of their own.

`BENCHMARK.json` at the root names the configurations, the cells
(`workloads`) and the metrics. Everything that belongs to one of them sits
in its own file under `benchmark/`, so that a new configuration, traffic
mix, cell, per-layer metric or entry is added as new files beside the
others, and no file needs an edit:

  * `configs/<config>.json`: the configuration as it is run (the program's
    config function, every field that the cell runs with, its source).
  * `traffic/<traffic>.json`: the entry the window drives and its
    parameters (batch, super-step, grid, the first steps the check reads).
  * `workloads/<cell>.json`: the cell's configuration, traffic and chips,
    and the limits of its correctness check (a training cell's
    `loss_steps`, if given, is how many checked steps' losses it compares).
  * `entries/<entry>.py`: the window loop of one entry point, a module with
    `run(ctx) -> dict`.
  * `metrics/<metric>.py`: the reader of one per-layer metric, a module
    with `read(record) -> float | None`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Any, Dict, List, Optional


def _load_json(path: str) -> Any:
  with open(path) as f:
    return json.load(f)


def _load_module(path: str, name: str) -> ModuleType:
  spec = importlib.util.spec_from_file_location(name, path)
  if spec is None or spec.loader is None:
    raise FileNotFoundError(path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[name] = module
  spec.loader.exec_module(module)
  return module


@dataclasses.dataclass
class Cell:
  """One cell with what it needs, read from the files under `root`."""
  root: str
  name: str
  entry: Dict[str, Any]        # the cell's BENCHMARK.json entry
  config: Dict[str, Any]       # configs/<config>.json
  traffic: Dict[str, Any]      # traffic/<traffic>.json
  workload: Dict[str, Any]     # workloads/<cell>.json
  end_to_end: List[Dict[str, Any]]
  per_layer: List[Dict[str, Any]]

  @property
  def chips(self) -> int:
    return int(self.entry['chips'])

  @property
  def limits(self) -> Dict[str, float]:
    return dict(self.workload.get('limits', {}))

  def entry_module(self) -> ModuleType:
    name = self.traffic['entry']
    return _load_module(os.path.join(self.root, 'benchmark', 'entries',
                                     f'{name}.py'), f'bench_entry_{name}')

  def metric_reader(self, name: str) -> ModuleType:
    return _load_module(os.path.join(self.root, 'benchmark', 'metrics',
                                     f'{name}.py'),
                        'bench_metric_' + name.replace('.', '_'))


def reports(metric: Dict[str, Any], cell: str,
            end_to_end_names: Optional[set] = None) -> bool:
  """Whether `cell` reports `metric`: every cell listed under its
  `workloads`, or without that key every cell that reports the end-to-end
  metric it moves (a per-layer metric) or every cell (an end-to-end one)."""
  if 'workloads' in metric:
    return cell in metric['workloads']
  if end_to_end_names is None or 'moves' not in metric:
    return True
  return metric['moves'] in end_to_end_names


def load_cell(root: str, name: str) -> Cell:
  bench = _load_json(os.path.join(root, 'BENCHMARK.json'))
  entries = [w for w in bench['workloads'] if w['name'] == name]
  if len(entries) != 1:
    raise KeyError(f'no cell {name!r} in BENCHMARK.json')
  entry = entries[0]
  configs = [c for c in bench['configs'] if c['name'] == entry['config']]
  if len(configs) != 1:
    raise KeyError(f'no configuration {entry["config"]!r} in BENCHMARK.json')
  config = _load_json(os.path.join(root, configs[0]['file']))
  bench_dir = os.path.join(root, 'benchmark')
  traffic = _load_json(os.path.join(bench_dir, 'traffic',
                                    f'{entry["traffic"]}.json'))
  workload = _load_json(os.path.join(bench_dir, 'workloads', f'{name}.json'))
  for key in ('config', 'traffic', 'chips'):
    if workload.get(key) != entry[key]:
      raise ValueError(f'workloads/{name}.json says {key}='
                       f'{workload.get(key)!r}, BENCHMARK.json '
                       f'{entry[key]!r}')
  e2e = [m for m in bench['end_to_end'] if reports(m, name)]
  names = {m['name'] for m in e2e}
  per_layer = [m for m in bench['per_layer'] if reports(m, name, names)]
  return Cell(root, name, entry, config, traffic, workload, e2e, per_layer)
