"""The control: the reference in the nearest precision below the
configuration's (float8 for the bf16 flagship), in the program's place.

On the CPU at the tiny size the control reads far above the program (the
program runs float32 there); on the card, at the cell's own size, the
control must fail the cell's limits (`chip`)."""

import io
import json
import contextlib

import pytest
import torch

from benchmark import readings
from benchmark.harness import spec
from benchmark.tests import tiny


def _readings(argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert readings.main(argv) == 0
  return [json.loads(l) for l in out.getvalue().splitlines()]


@pytest.mark.parametrize('cell', ['c10-train-b128', 'c10-dense-eval-512'])
def test_control_reads_above_the_program_on_the_cpu(tmp_path, cell):
  root = tiny.make_root(str(tmp_path))
  lines = _readings(['--workload', cell, '--seeds', '5', '--control-seeds',
                     '5', '--controls', 'fp8', '--root', root,
                     '--device', 'cpu'])
  program = next(l for l in lines if l['side'] == 'program')['numbers']
  control = next(l for l in lines if l['side'] == 'fp8')['numbers']
  first = 'loss' if 'loss' in program else 'bpd'
  assert control[first] > 100 * program[first]


def test_dump_names_the_leaves_and_the_top_k_rows(tmp_path):
  from benchmark.reference import mulan as ref
  from mulan_tpu_torch.models import latents
  before = latents.topk_embedding, ref.topk_embedding
  root = tiny.make_root(str(tmp_path))
  lines = _readings(['--workload', 'in32-train-b128', '--seeds', '5',
                     '--control-seeds', '5', '--controls', 'fp8', '--root',
                     root, '--device', 'cpu', '--dump'])
  assert (latents.topk_embedding, ref.topk_embedding) == before
  program = next(l for l in lines if l['side'] == 'program')
  traffic = tiny.TINY_TRAFFIC['train-b128-s8']
  rows = program['topk']['rows']
  assert rows[0] == rows[1] == traffic['substeps'] * traffic['batch']
  assert program['topk']['n_differ'] == 0
  assert program['moment_norms'] and all(
      p > 0 and r > 0 for p, r in program['moment_norms'].values())


@pytest.mark.chip
@pytest.mark.parametrize('cell', ['c10-train-b128', 'in32-train-b128',
                                  'c10-dense-eval-512'])
def test_control_fails_the_limits_on_the_card(cell):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  limits = spec.load_cell(tiny.REPO, cell).limits
  lines = _readings(['--workload', cell, '--control-seeds', '7',
                     '--controls', 'fp8'])
  numbers = lines[0]['numbers']
  assert any(numbers[k] > limits[k] for k in limits), numbers
