"""Nothing a run loads is JAX or the JAX package, compared by top-level
name as a whole; the reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import imports
from benchmark.tests import tiny

BENCH = os.path.join(tiny.REPO, 'benchmark')


def test_names_compare_whole_top_level_names():
  assert imports.forbidden(['jax', 'jax.numpy', 'jaxlib.xla', 'flax.linen',
                            'mulan_tpu', 'mulan_tpu.models']) == [
      'flax.linen', 'jax', 'jax.numpy', 'jaxlib.xla', 'mulan_tpu',
      'mulan_tpu.models']
  assert imports.forbidden(['mulan_tpu_torch', 'mulan_tpu_torch.ops',
                            'jaxtyping', 'flaxen', 'torch']) == []


def _imported(path):
  names = set()
  for node in ast.walk(ast.parse(open(path).read())):
    if isinstance(node, ast.Import):
      names.update(a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      names.add(node.module.split('.')[0])
  return names


def test_no_benchmark_source_names_jax():
  for path in glob.glob(os.path.join(BENCH, '**', '*.py'), recursive=True):
    if os.sep + 'tests' + os.sep in path:
      continue
    assert not imports.forbidden(_imported(path)), path


def test_reference_imports_nothing_of_the_program():
  for path in glob.glob(os.path.join(BENCH, 'reference', '*.py')):
    assert 'mulan_tpu_torch' not in _imported(path), path
  code = ('import sys; sys.path.insert(0, %r); '
          'import benchmark.reference.mulan, benchmark.reference.train, '
          'benchmark.reference.philox; '
          'print(sorted(m for m in sys.modules if m.split(".")[0] in '
          '("mulan_tpu_torch", "mulan_tpu", "jax", "flax", "jaxlib")))'
          % tiny.REPO)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120, check=True).stdout
  assert out.strip() == '[]'


_RUN = '''
import io, sys, time
sys.path.insert(0, {repo!r})
{plant}
from benchmark.harness import imports, runner
from benchmark.tests import tiny
root = tiny.make_root({tmp!r})
out = io.StringIO()
rc = runner.main(['--workload', 'c10-dense-eval-512', '--seed', '5',
                  '--seconds', '0.5'], time.perf_counter(), root,
                 device='cpu', require_chip=False, out=out)
print('RC', rc, 'FORBIDDEN', imports.loaded_forbidden(), 'LINES',
      len(out.getvalue().splitlines()))
'''


def test_a_run_loads_no_forbidden_module(tmp_path):
  code = _RUN.format(repo=tiny.REPO, tmp=str(tmp_path), plant='')
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, check=True).stdout
  assert 'RC 0 FORBIDDEN [] LINES 1' in out


def test_a_run_that_loaded_jax_prints_no_result(tmp_path):
  plant = 'import types; sys.modules["jax"] = types.ModuleType("jax")'
  code = _RUN.format(repo=tiny.REPO, tmp=str(tmp_path), plant=plant)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, check=True).stdout
  assert 'RC 4' in out and 'LINES 0' in out
