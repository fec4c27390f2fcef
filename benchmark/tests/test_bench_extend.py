"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new BENCHMARK.json entries, with no existing file edited,
run as the others do."""

import hashlib
import json
import os

from benchmark.tests import runs, tiny

NEW_METRIC = '''"""Optimizer steps a call of the train entry."""


def read(record):
  if record['entry'] != 'train':
    return None
  return float(record['steps_per_call'])
'''


def _digests(root):
  out = {}
  for d, _, files in os.walk(root):
    for f in files:
      path = os.path.join(d, f)
      with open(path, 'rb') as fh:
        out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
  return out


def test_new_files_add_a_cell_a_configuration_and_a_metric(tmp_path):
  root = tiny.make_root(str(tmp_path))
  before = _digests(root)
  bench_path = os.path.join(root, 'BENCHMARK.json')
  with open(bench_path) as f:
    bench = json.load(f)
  # A configuration: the flagship with 3 layers, a file of its own.
  with open(os.path.join(root, 'benchmark', 'configs',
                         'cifar10_conditioned.json')) as f:
    config = json.load(f)
  config['name'] = 'c10_three_layers'
  config['model']['sm_n_layer'] = 3
  new = {
      'benchmark/configs/c10_three_layers.json': config,
      'benchmark/traffic/train-b6-s2.json': {
          'entry': 'train', 'batch': 6, 'substeps': 2, 'check_calls': 1,
          'trace_calls': 1, 'rows_per_block': 4},
      'benchmark/workloads/c10x3-train-b6.json': {
          'config': 'c10_three_layers', 'traffic': 'train-b6-s2', 'chips': 1,
          'limits': {'loss': 1e-3, 'moment': 1e-2, 'change': 1e-2}},
  }
  for rel, data in new.items():
    with open(os.path.join(root, rel), 'w') as f:
      json.dump(data, f)
  with open(os.path.join(root, 'benchmark', 'metrics',
                         'steps_per_call.train.py'), 'w') as f:
    f.write(NEW_METRIC)
  bench['configs'].append({
      'name': 'c10_three_layers', 'source': 'https://example.org/config',
      'file': 'benchmark/configs/c10_three_layers.json', 'reduced': [],
      'why': 'a test'})
  bench['workloads'].append({
      'name': 'c10x3-train-b6', 'config': 'c10_three_layers',
      'traffic': 'train-b6-s2', 'chips': 1, 'why': 'a test'})
  bench['per_layer'].append({
      'name': 'steps_per_call.train', 'unit': 'steps', 'better': 'higher',
      'source': 'program_counter', 'layer': 'a test',
      'moves': 'train_images_per_s', 'workloads': ['c10x3-train-b6']})
  for m in bench['end_to_end']:
    if m['name'] == 'train_images_per_s':
      m['workloads'].append('c10x3-train-b6')
  with open(bench_path, 'w') as f:
    json.dump(bench, f)

  rc, line, err = runs.run_cell(root, 'c10x3-train-b6', trace=1)
  assert rc == 0, err
  assert line['correct'], err
  assert line['metrics']['steps_per_call.train']['value'] == 2.0
  rc, line, err = runs.run_cell(root, 'c10x3-train-b6')
  assert rc == 0 and line['correct'], err
  assert set(line['metrics']) == {'train_images_per_s', 'peak_mem_gib',
                                  'setup_s'}
  after = _digests(root)
  changed = sorted(k for k in before if before[k] != after.get(k))
  assert changed == ['BENCHMARK.json']
