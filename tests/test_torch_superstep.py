"""The port's super-step against JAX's (`mulan_tpu/train/loop.py:149-305`):
`Experiment.train_superstep` against `substeps` single `train_step` calls
bit for bit; the (kind, step) events of `train_and_evaluate` (logs,
evaluations, sample grids, saves and the profile trace) against JAX's loop
on the same config, and the logged train scalars as the super-step's means;
`nan_guard` naming the bad substep in JAX's words; the super-batches of
`create_dataset` with augmentation bit for bit JAX's `pipeline.py`.

JAX's loop runs on a stand-in Experiment whose super-step returns the
per-substep scalars the port's run produced, whose checkpoint manager,
writer and profiler record what they are asked to do, and whose evaluation
and sampler are recorders: nothing of JAX's is compiled.
"""

import functools
import itertools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.data import pipeline
from mulan_tpu.train import loop as jax_loop
from mulan_tpu_torch import configs, data
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import Experiment
from mulan_tpu_torch.utils import metrics as metrics_lib
from test_torch_checkpoint import _tensors
from test_torch_loop_hooks import _jax_guard_message

# The logged means against the mean of the substeps' float32 values: a
# few float32 rounding steps.
MEAN_RTOL = 1e-6


@pytest.fixture
def short_sampler(monkeypatch):
  """The in-training sampler at 2 steps instead of 1000."""
  monkeypatch.setattr(Experiment, 'draw_samples', functools.partialmethod(
      Experiment.draw_samples, T=2))


def _config(**training):
  """tiny_synthetic (2 substeps) with a one-step warm-up and lr 2e-3, so
  that every step after the first moves the parameters."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, training={'num_steps_lr_warmup': 1, **training},
      optimizer=configs.OptimizerConfig(learning_rate=2e-3))


def _jax_config(cfg):
  """JAX's tiny_synthetic with the port config's training fields."""
  jcfg = jax_tiny_synthetic.get_config()
  for name, value in vars(cfg.training).items():
    jcfg.training[name] = value
  return jcfg


# -- the super-step ---------------------------------------------------------------


@pytest.mark.parametrize('substeps', [2, 3])
def test_superstep_is_substeps_single_steps_bit_for_bit(substeps):
  """One `train_superstep` on the iterator's first super-batch against
  `train_step` on each of its batches from the same start: the scalars
  (stacked (substeps,) on the device), the parameters, the EMA and the
  AdamW moments, bit for bit."""
  cfg = _config(substeps=substeps)
  ex = Experiment(cfg, device='cpu')
  superbatch = next(ex.train_iter)
  assert superbatch['images'].shape == (substeps, 8, 8, 8, 3)
  got = ex.train_superstep(superbatch)
  assert ex.state.step == substeps

  one = Experiment(cfg, device='cpu')
  steps = [one.train_step({k: v[i] for k, v in superbatch.items()})
           for i in range(substeps)]
  assert got.keys() == steps[0].keys()
  for name, values in got.items():
    assert values.shape == (substeps,), name
    assert torch.equal(values, torch.stack([s[name] for s in steps])), name
  want, mine = _tensors(one.state), _tensors(ex.state)
  assert mine.keys() == want.keys()
  for name, w in want.items():
    assert torch.equal(mine[name], w), name


def test_resume_at_a_superstep_boundary_is_bit_exact(tmp_path):
  """Two super-steps straight against one, a checkpoint, a fresh
  Experiment restored from it and the second, on the same super-batches:
  the scalars and every tensor of the state bit for bit."""
  cfg = _config()
  straight = Experiment(cfg, device='cpu')
  superbatches = [next(straight.train_iter) for _ in range(2)]
  want = [straight.train_superstep(b) for b in superbatches]

  first = Experiment(cfg, device='cpu')
  got = [first.train_superstep(superbatches[0])]
  ckpt_lib.CheckpointManager(tmp_path).save(first.state.step, first.state)
  second = Experiment(cfg, device='cpu')
  ckpt_lib.CheckpointManager(tmp_path).restore(second.state)
  assert second.state.step == 2
  got.append(second.train_superstep(superbatches[1]))
  for g, w in zip(got, want):
    assert all(torch.equal(g[k], v) for k, v in w.items())
  mine, theirs = _tensors(second.state), _tensors(straight.state)
  assert mine.keys() == theirs.keys()
  for name, w in theirs.items():
    assert torch.equal(mine[name], w), name


def test_train_refuses_a_partial_superstep():
  ex = Experiment(_config(substeps=2), device='cpu')
  with pytest.raises(ValueError, match='multiple of training.substeps = 2'):
    ex.train(3)
  assert ex.state.step == 0
  assert len(ex.train(4)) == 4 and ex.state.step == 4


# -- train_and_evaluate's cadence against JAX's loop ----------------------------


class _Writer:
  """Records (kind, step, scalars) of what a loop writes: 'log' for the
  train scalars, 'eval' for the evaluation's, 'images' and 'hparams'."""

  def __init__(self, events):
    self.events = events

  def write_hparams(self, hparams):
    self.events.append(('hparams', 0, None))

  def write_scalars(self, step, scalars):
    kind = 'log' if any(k.startswith('train_') for k in scalars) else 'eval'
    self.events.append((kind, int(step), dict(scalars)))

  def write_images(self, step, images):
    self.events.append(('images', int(step), None))

  def flush(self):
    pass

  def close(self):
    pass


def _port_events(monkeypatch, cfg, workdir):
  """(events, the super-steps' scalars {name: (substeps,) numpy}) of the
  port's `train_and_evaluate` in `workdir`."""
  events, superstep_scalars = [], []
  real_superstep = Experiment.train_superstep
  real_save = ckpt_lib.CheckpointManager.save
  real_profiled = Experiment._profiled

  def superstep(self, superbatch):
    out = real_superstep(self, superbatch)
    superstep_scalars.append({k: v.numpy().copy() for k, v in out.items()})
    return out

  def save(self, step, state):
    events.append(('save', int(step), None))
    return real_save(self, step, state)

  def profiled(self, logdir, step):
    events.append(('profile', int(step), None))
    return real_profiled(self, logdir, step)

  with monkeypatch.context() as m:
    m.setattr(Experiment, 'train_superstep', superstep)
    m.setattr(ckpt_lib.CheckpointManager, 'save', save)
    m.setattr(Experiment, '_profiled', profiled)
    m.setattr(metrics_lib, 'create_writer', lambda workdir, rank: _Writer(
        events))
    Experiment(cfg, device='cpu').train_and_evaluate(str(workdir))
  return events, superstep_scalars


def _jax_events(monkeypatch, jcfg, superstep_scalars, initial_step=0):
  """The events of JAX's `train_and_evaluate` on a stand-in whose
  super-steps return `superstep_scalars` in turn, resumed at
  `initial_step` when it is not 0."""
  events = []
  substeps = jcfg.training.substeps
  scalars = iter(superstep_scalars)
  now = {'step': initial_step}

  class Checkpoints:

    def __init__(self, directory):
      del directory

    def latest_step(self):
      return initial_step or None

    def restore(self, state):
      return types.SimpleNamespace(step=initial_step, ema_params=None)

    def save(self, step, state):
      events.append(('save', int(step), None))

    def wait(self):
      pass

  def superstep(state, superbatch):
    now['step'] = state.step + substeps
    return (types.SimpleNamespace(step=now['step'], ema_params=None),
            next(scalars))

  def run_eval(ema_params, num_steps_eval):
    return {'eval_bpd': 0.0}

  fake = types.SimpleNamespace(
      config=jcfg, state=types.SimpleNamespace(step=0, ema_params=None),
      train_iter=itertools.repeat(None), _put_state=lambda s: s,
      _put_superbatch=lambda b: b, _p_superstep=superstep,
      _run_eval=run_eval,
      _draw_samples=lambda ema: np.zeros((2, 2, 3), np.uint8))
  with monkeypatch.context() as m:
    m.setattr(jax_loop.ckpt_lib, 'CheckpointManager', Checkpoints)
    m.setattr(jax_loop, 'create_writer', lambda workdir, index: _Writer(
        events))
    m.setattr(jax.profiler, 'start_trace', lambda logdir: events.append(
        ('profile', now['step'], None)))
    m.setattr(jax.profiler, 'stop_trace', lambda: None)
    jax_loop.Experiment.train_and_evaluate(fake, 'unused')
  return events


def _kinds(events):
  return [(kind, step) for kind, step, _ in events]


def _optimizer_steps(path) -> int:
  with open(path) as f:
    return sum(e.get('name', '').startswith('Optimizer.step#')
               for e in json.load(f)['traceEvents']
               if e.get('cat') == 'user_annotation')


CADENCES = {
    # tiny_synthetic as it is: 4 steps in super-steps of 2.
    'tiny': {},
    # Logging and saving every second super-step, evaluation every third,
    # and the profile of the second super-step.
    'spread': dict(num_steps_train=10, steps_per_logging=4,
                   steps_per_eval=6, steps_per_save=4, profile=True),
    # Super-steps of 3 to a target they overshoot (8 -> 9).
    'overshoot': dict(substeps=3, num_steps_train=8, steps_per_logging=3,
                      steps_per_eval=6, steps_per_save=6, profile=True),
}


@pytest.mark.parametrize('cadence', list(CADENCES))
def test_train_and_evaluate_events_match_jax_loop(monkeypatch, tmp_path,
                                                  short_sampler, cadence):
  """The port's (kind, step) events, in order, are JAX's on the same
  config; each logged train scalar is the mean of its super-step's
  per-substep values (JAX's, fed the same values, within MEAN_RTOL); a
  profile trace covers the whole second super-step."""
  cfg = _config(**CADENCES[cadence])
  events, superstep_scalars = _port_events(monkeypatch, cfg,
                                           tmp_path / 'run')
  want = _jax_events(monkeypatch, _jax_config(cfg), superstep_scalars)
  assert _kinds(events) == _kinds(want)
  substeps = cfg.training.substeps
  assert len(superstep_scalars) == -(-cfg.training.num_steps_train //
                                     substeps)

  logs = [(step, s) for kind, step, s in events if kind == 'log']
  jax_logs = [s for kind, _, s in want if kind == 'log']
  assert logs
  for (step, scalars), theirs in zip(logs, jax_logs):
    mine = superstep_scalars[step // substeps - 1]
    assert set(scalars) == set(theirs) == {
        'steps_per_sec', *(f'train_{k}' for k in mine)}
    for name, values in mine.items():
      mean = np.mean(values.astype(np.float64))
      np.testing.assert_allclose(scalars[f'train_{name}'], mean,
                                 rtol=MEAN_RTOL, err_msg=name)
      np.testing.assert_allclose(scalars[f'train_{name}'],
                                 theirs[f'train_{name}'], rtol=MEAN_RTOL,
                                 err_msg=name)
    assert scalars['steps_per_sec'] > 0

  profiles = [step for kind, step, _ in events if kind == 'profile']
  if cfg.training.profile:
    assert profiles == [substeps]
    path = tmp_path / 'run' / 'profile' / f'train_{substeps}.pt.trace.json'
    assert os.listdir(path.parent) == [path.name]
    assert _optimizer_steps(path) == substeps
  else:
    assert not profiles


def test_resumed_run_events_match_jax_loop(monkeypatch, tmp_path,
                                           short_sampler):
  """A run of 4 steps, then the same workdir to 8 with the profile on:
  the resumed run's events (no hparams, the profile of the super-step
  from step 6) are JAX's resumed at step 4."""
  cfg = _config()
  Experiment(cfg, device='cpu').train_and_evaluate(str(tmp_path / 'run'))
  resumed = configs.replace(cfg, training={'num_steps_train': 8,
                                           'profile': True})
  events, superstep_scalars = _port_events(monkeypatch, resumed,
                                           tmp_path / 'run')
  want = _jax_events(monkeypatch, _jax_config(resumed), superstep_scalars,
                     initial_step=4)
  assert _kinds(events) == _kinds(want) == [
      ('log', 6), ('profile', 6), ('log', 8), ('eval', 8), ('images', 8),
      ('save', 8)]


# -- nan_guard --------------------------------------------------------------------


def test_nan_guard_names_the_substep_as_jax(monkeypatch):
  """Super-steps of 3 with a NaN planted in 'var' at substep 2 and an inf
  in 'bpd_recon' at substep 1 of the second super-step: the guard reads
  after the super-step and names 'bpd_recon' (the first bad name in sorted
  order) at substep 1 of the super-step ending at step 6, in JAX's words
  for the same scalars."""
  ex = Experiment(_config(substeps=3, nan_guard=True), device='cpu')
  step = ex.train_step
  seen = []

  def planting_step(batch, noise=None):
    scalars = step(batch, noise)
    if ex.state.step == 5:
      scalars['bpd_recon'] = torch.tensor(float('inf'))
    if ex.state.step == 6:
      scalars['var'] = torch.tensor(float('nan'))
    seen.append(scalars)
    return scalars
  ex.train_step = planting_step
  with pytest.raises(FloatingPointError) as raised:
    ex.train(9)
  assert len(seen) == 6 and ex.state.step == 6
  got = str(raised.value)
  last = {k: np.asarray([s[k].item() for s in seen[3:]], np.float32)
          for k in seen[0]}
  assert got == _jax_guard_message(monkeypatch, last, 6)
  assert got.startswith("nan_guard: non-finite 'bpd_recon' at substep 1 of "
                        'the super-step ending at step 6 (value '), got


# -- the super-batches ---------------------------------------------------------------


@pytest.mark.parametrize('name', ['x_aug', 'x_aug_with_channel'])
def test_augmented_superbatches_match_pipeline(tmp_path, name):
  """`create_dataset` at substeps = 3 on `npz:<dir>/<name>`: 4 super-batches
  (3 x 8 images, augmented in one draw over the 24) bit for bit JAX's
  `pipeline.create_dataset`. Drawn per batch of 8 instead, the same
  permutation gives other images."""
  root = tmp_path / name
  os.makedirs(root)
  for split, seed in (('train', 5), ('eval', 6)):
    images, labels = data.synthetic(seed, 40, (8, 8, 3))
    noise = np.random.default_rng(seed).integers(0, 64, images.shape)
    np.savez(root / f'{split}.npz', images=(images // 2 + noise).astype(
        np.uint8), labels=labels)
  cfg = configs.replace(configs.tiny_synthetic(),
                        data={'dataset': f'npz:{root}'},
                        training={'substeps': 3})
  jcfg = _jax_config(cfg)
  jcfg.data.dataset = cfg.data.dataset
  want_train, _ = pipeline.create_dataset(jcfg, seed=11)
  got_train, _ = data.create_dataset(cfg, seed=11)
  first = None
  for i in range(4):
    g, w = next(got_train), next(want_train)
    assert g.keys() == w.keys()
    for key in w:
      assert g[key].shape[:2] == (3, 8), key
      np.testing.assert_array_equal(g[key], w[key], err_msg=f'{i}: {key}')
      assert g[key].dtype == w[key].dtype
    first = first or g
  assert first['conditioning'].any()

  per_batch = data.train_iterator(
      *data.config_source(cfg, 'train'), batch_size=8, substeps=1,
      seed=11, augment=True, channel_flip=name.endswith('with_channel'),
      prefetch=False)
  old = np.concatenate([next(per_batch)['images'] for _ in range(3)])
  assert not np.array_equal(old, first['images'].reshape(old.shape))


def test_superbatch_reaches_the_device_in_one_copy(monkeypatch):
  """`train_superstep` copies each array of the super-batch once, then
  hands `train_step` views of it."""
  ex = Experiment(_config(), device='cpu')
  copies = []
  real_put = Experiment._put_superbatch

  def put(self, superbatch):
    out = real_put(self, superbatch)
    copies.append(out)
    return out
  monkeypatch.setattr(Experiment, '_put_superbatch', put)
  seen = []
  step = ex.train_step
  ex.train_step = lambda batch, noise=None: seen.append(batch) or step(
      batch, noise)
  ex.train(2)
  assert len(copies) == 1 and len(seen) == 2
  for i, batch in enumerate(seen):
    for k, v in batch.items():
      assert isinstance(v, torch.Tensor), k
      assert v.data_ptr() == copies[0][k][i].data_ptr(), k
