"""A run whose timed path is broken underneath must come out not correct:
once for each fault a cell can have. The cells run at the tiny size on
the CPU with their real limits; the faults are planted in the program.
The exchange between chips does not exist in these one-chip cells."""

import pytest
import torch

from benchmark.tests import runs, tiny
from mulan_tpu_torch.evals import vlb
from mulan_tpu_torch.models import mulan as mulan_lib
from mulan_tpu_torch.models.outputs import ELBOOutput
from mulan_tpu_torch.train import state as state_lib

TRAIN_CELLS = ['c10-train-b128', 'in32-train-b128']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
  return tiny.make_root(str(tmp_path_factory.mktemp('bench')))


def _unchanged(monkeypatch):
  """A step that leaves the state as it was (the step count moves)."""
  def apply_gradients(self, ema_rate):
    self.step += 1
  monkeypatch.setattr(state_lib.TrainState, 'apply_gradients',
                      apply_gradients)


def _elbo_fault(monkeypatch, change):
  real = mulan_lib.MuLAN.elbo

  def elbo(self, *args, **kwargs):
    return change(real(self, *args, **kwargs))
  monkeypatch.setattr(mulan_lib.MuLAN, 'elbo', elbo)


def _half_batch(out):
  """The second half of the batch left out, the mean over the rest."""
  half = out.loss_recon.shape[0] // 2
  return ELBOOutput(out.loss_recon[:half], out.loss_klz[:half],
                    out.loss_diff[:half], out.var_0, out.var_1)


def _answer(out):
  """The first example's ELBO doubled where it is produced."""
  def doubled(x):
    return torch.cat([2 * x[:1], x[1:]])
  return ELBOOutput(doubled(out.loss_recon), doubled(out.loss_klz),
                    doubled(out.loss_diff), out.var_0, out.var_1)


@pytest.mark.parametrize('cell', TRAIN_CELLS)
@pytest.mark.parametrize('fault', ['unchanged', 'half_batch', 'answer'])
def test_train_faults_fail(root, monkeypatch, cell, fault):
  if fault == 'unchanged':
    _unchanged(monkeypatch)
  else:
    _elbo_fault(monkeypatch, {'half_batch': _half_batch,
                              'answer': _answer}[fault])
  rc, line, err = runs.run_cell(root, cell)
  assert rc == 0, err
  assert line['correct'] is False, line['checks']


def _chunk_fault(monkeypatch, change):
  real = vlb.dense_chunk_bpd

  def chunk(*args, **kwargs):
    return change(real(*args, **kwargs))
  monkeypatch.setattr(vlb, 'dense_chunk_bpd', chunk)


def _first_zero(bpd):
  return torch.cat([torch.zeros_like(bpd[:1]), bpd[1:]])


@pytest.mark.parametrize('fault', ['half_batch', 'answer'])
def test_dense_faults_fail(root, monkeypatch, fault):
  _chunk_fault(monkeypatch, {'half_batch': lambda b: b[:max(1, len(b) // 2)],
                             'answer': _first_zero}[fault])
  rc, line, err = runs.run_cell(root, 'c10-dense-eval-512')
  assert rc == 0, err
  assert line['correct'] is False, line['checks']


@pytest.mark.parametrize('cell', TRAIN_CELLS + ['c10-dense-eval-512'])
def test_sound_runs_are_correct(root, cell):
  rc, line, err = runs.run_cell(root, cell, trace=1)
  assert rc == 0, err
  assert line['correct'] is True, line['checks']
  assert list(line)[-1] == 'checks'
  last = err.strip().splitlines()[-len(line['checks']):]
  assert all(l.startswith('[check] ') for l in last)
