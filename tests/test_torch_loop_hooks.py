"""The training loop's debug hooks and writers against the JAX loop's:
`training.nan_guard` (the first non-finite scalar and its substep named as
JAX's guard names them, and a clean guarded run bit for bit the unguarded
one), `training.profile` (one torch.profiler trace of the run's second
super-step, on rank 0 only) and the TensorBoard writer (JAX's scalar tags, steps and
values, the `samples` image and the hparams, read back with tensorboard's
`EventAccumulator`).

JAX's guard runs through `Experiment._compile_steps` on a stand-in
Experiment whose super-step is replaced by one that returns the given
scalars: the message is what JAX's guard makes of them, without compiling
JAX's train step.
"""

import functools
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.models import build_model as build_jax_model
from mulan_tpu.parallel import mesh as jax_mesh
from mulan_tpu.train import loop as jax_loop
from mulan_tpu.train.state import TrainState as JaxTrainState
from mulan_tpu_torch import configs
from mulan_tpu_torch.parallel import mesh as mesh_lib
from mulan_tpu_torch.train.loop import Experiment
from mulan_tpu_torch.utils import metrics as metrics_lib
from torch_port_helpers import REAL_SUMMARY_WRITER, jax_config


@pytest.fixture
def short_sampler(monkeypatch):
  """The in-training sampler at 2 steps instead of 1000."""
  monkeypatch.setattr(Experiment, 'draw_samples', functools.partialmethod(
      Experiment.draw_samples, T=2))


def _guarded(**training):
  return configs.replace(configs.tiny_synthetic(),
                         training={'nan_guard': True, **training})


# -- nan_guard -------------------------------------------------------------------


def _jax_guard_message(monkeypatch, scalars, step_after: int) -> str:
  """JAX's nan_guard message for a super-step that ends at `step_after`
  with `scalars` ({name: the substeps' values})."""
  jcfg = jax_tiny_synthetic.get_config()
  jcfg.training.nan_guard = True
  mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
  fake = types.SimpleNamespace(
      config=jcfg, mesh=mesh, _replicated=jax_mesh.replicated_sharding(mesh),
      state=JaxTrainState.create(apply_fn=None, params={'w': jnp.zeros(1)},
                                 tx=optax.identity()),
      _train_rng=jax.random.PRNGKey(1), _eval_rng=jax.random.PRNGKey(2),
      _sample_rng=jax.random.PRNGKey(3))
  metrics = {k: np.asarray(v, np.float32).reshape(-1)
             for k, v in scalars.items()}
  real_jit = jax.jit

  def fake_jit(fn, **kwargs):
    if fn.__name__ == 'superstep':
      return lambda state, superbatch: (
          types.SimpleNamespace(step=jnp.asarray(step_after)), metrics)
    return real_jit(fn, **kwargs)

  with monkeypatch.context() as m:
    m.setattr(jax, 'jit', fake_jit)
    jax_loop.Experiment._compile_steps(fake)
  with pytest.raises(FloatingPointError) as raised:
    fake._p_superstep(fake.state, None)
  return str(raised.value)


@pytest.mark.parametrize('planted', ['var0', 'params'])
def test_nan_guard_names_the_scalar_and_step_as_jax(monkeypatch, planted):
  """A NaN planted in the scalar `var0` alone at the second step, or in
  every parameter before the first: after the first super-step (2 steps)
  the port's guard raises JAX's message for the same scalars and step
  ('var0' at substep 1; 'bpd', the first in sorted order, at substep 0;
  both of the super-step ending at step 2)."""
  cfg = _guarded()
  seen = []
  if planted == 'var0':
    ex = Experiment(cfg, device='cpu')
    step = ex.train_step

    def planting_step(batch, noise=None):
      scalars = step(batch, noise)
      if ex.state.step == 2:
        scalars['var0'] = torch.tensor(float('nan'))
      seen.append(scalars)
      return scalars
    ex.train_step = planting_step
  else:
    ex = Experiment(cfg, device='cpu')
    with torch.no_grad():
      for p in ex.state.params.values():
        p.mul_(float('nan'))
    step = ex.train_step
    ex.train_step = lambda batch, noise=None: seen.append(
        step(batch, noise)) or seen[-1]
  with pytest.raises(FloatingPointError) as raised:
    ex.train(4)
  got = str(raised.value)
  want = _jax_guard_message(monkeypatch, {k: [s[k].item() for s in seen]
                                          for k in seen[0]}, ex.state.step)
  assert got == want
  name, bad = ('var0', 1) if planted == 'var0' else ('bpd', 0)
  assert got.startswith(f'nan_guard: non-finite {name!r} at substep {bad} '
                        'of the super-step ending at step 2 '), got
  assert len(seen) == 2


def test_clean_guarded_run_is_the_unguarded_run():
  """Two super-steps with the guard: the same scalars, parameters and EMA
  bit for bit as two without it."""
  runs = []
  for guard in (False, True):
    ex = Experiment(_guarded(nan_guard=guard), device='cpu')
    runs.append((ex.train(4), ex.state))
  (history, state), (guarded_history, guarded_state) = runs
  assert history == guarded_history
  for slot in ('params', 'ema_params'):
    mine, theirs = getattr(guarded_state, slot), getattr(state, slot)
    assert all(torch.equal(mine[k], v) for k, v in theirs.items()), slot


# -- the profile hook --------------------------------------------------------------


def _train_annotations(path) -> int:
  with open(path) as f:
    events = json.load(f)['traceEvents']
  return sum(e.get('name') == 'train' and e.get('cat') == 'user_annotation'
             for e in events)


def test_profile_traces_the_second_step_once_on_rank_0(tmp_path,
                                                       monkeypatch,
                                                       short_sampler):
  """A run of 4 steps in super-steps of 2 traces the one from step 2 (the
  second); the run resumed from its step-4 checkpoint to step 8 traces
  the one from step 6; a rank other than 0 traces nothing. Each trace
  holds the one super-step's 'train' annotation."""
  workdir = tmp_path / 'run'
  cfg = configs.replace(configs.tiny_synthetic(),
                        training={'profile': True, 'num_steps_train': 4})
  Experiment(cfg, device='cpu').train_and_evaluate(str(workdir))
  profile = workdir / 'profile'
  assert os.listdir(profile) == ['train_2.pt.trace.json']
  Experiment(configs.replace(cfg, training={'num_steps_train': 8}),
             device='cpu').train_and_evaluate(str(workdir))
  assert sorted(os.listdir(profile)) == ['train_2.pt.trace.json',
                                         'train_6.pt.trace.json']
  for name in os.listdir(profile):
    assert _train_annotations(profile / name) == 1, name

  ex = Experiment(cfg, device='cpu')
  monkeypatch.setattr(mesh_lib, 'rank', lambda: 1)  # the loop's rank
  ex.train_and_evaluate(str(tmp_path / 'rank1'))
  assert not (tmp_path / 'rank1' / 'profile').exists()


# -- the TensorBoard writer ----------------------------------------------------------


def _jax_scalar_keys(cfg):
  """The keys of JAX's `Experiment.loss_fn` scalars for the port config's
  model, by abstract evaluation (no compile)."""
  model_cfg = jax_config(cfg.model)
  fake = types.SimpleNamespace(
      model=build_jax_model(cfg.vdm_type, model_cfg), model_config=model_cfg)
  batch = {'images': jnp.zeros((2, *model_cfg.image_shape), jnp.uint8),
           'labels': jnp.zeros((2,), jnp.int32),
           'conditioning': jnp.zeros((2,), jnp.uint8)}

  def scalars():
    params = fake.model.init(
        {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)},
        **batch, step=-1.0)['params']
    return jax_loop.Experiment.loss_fn(fake, params, batch, 0,
                                       jax.random.PRNGKey(2), False)[1]
  return sorted(jax.eval_shape(scalars))


def test_tensorboard_writer_holds_jax_tags_steps_values_samples_hparams(
    tmp_path, monkeypatch, short_sampler):
  """`train_and_evaluate` on the tiny config (4 steps in super-steps of 2,
  logs at 2 and 4, evaluations after the first super-step and at 4, as
  JAX's loop) with TensorBoard's writer: the event file
  holds JAX's scalar tags ('train_' and 'eval_' with JAX's loss keys, and
  'steps_per_sec'), at the steps and with the values the stdout writer
  printed, the sample grids under 'samples' and the config's hparams."""
  from PIL import Image
  from tensorboard.backend.event_processing.event_accumulator import (
      EventAccumulator)
  from tensorboard.plugins.hparams import plugin_data_pb2

  monkeypatch.setattr(metrics_lib, 'summary_writer', REAL_SUMMARY_WRITER)
  written = {'scalars': [], 'images': []}
  real_scalars = metrics_lib.ScalarWriter.write_scalars
  real_images = metrics_lib.ScalarWriter.write_images

  def record_scalars(self, step, scalars):
    written['scalars'].append((step, dict(scalars)))
    real_scalars(self, step, scalars)

  def record_images(self, step, images):
    written['images'].append((step, images['samples'][0]))
    real_images(self, step, images)
  monkeypatch.setattr(metrics_lib.ScalarWriter, 'write_scalars',
                      record_scalars)
  monkeypatch.setattr(metrics_lib.ScalarWriter, 'write_images',
                      record_images)
  cfg = configs.tiny_synthetic()
  workdir = str(tmp_path / 'run')
  Experiment(cfg, device='cpu').train_and_evaluate(workdir)

  events = EventAccumulator(workdir, size_guidance={'scalars': 0,
                                                    'images': 0})
  events.Reload()
  keys = _jax_scalar_keys(cfg)
  want_tags = {'steps_per_sec', *(f'{p}_{k}' for p in ('train', 'eval')
                                  for k in keys)}
  assert set(events.Tags()['scalars']) == want_tags
  want = {}
  for step, scalars in written['scalars']:
    for tag, value in scalars.items():
      want.setdefault(tag, []).append((step, np.float32(value)))
  assert want.keys() == want_tags
  for tag, points in want.items():
    got = [(e.step, np.float32(e.value)) for e in events.Scalars(tag)]
    assert got == points, tag
  assert [s for s, _ in want['train_bpd']] == [2, 4]
  assert [s for s, _ in want['eval_bpd']] == [2, 4]

  assert events.Tags()['images'] == ['samples']
  images = events.Images('samples')
  assert [e.step for e in images] == [s for s, _ in written['images']] == [
      2, 4]
  for event, (_, grid) in zip(images, written['images']):
    png = np.asarray(Image.open(io.BytesIO(event.encoded_image_string)))
    np.testing.assert_array_equal(png, grid)

  content = events.PluginTagToContent('hparams')
  info = plugin_data_pb2.HParamsPluginData.FromString(
      content['_hparams_/session_start_info']).session_start_info
  flat = metrics_lib.flatten_hparams(cfg)
  assert set(info.hparams) == set(flat)
  for name, value in flat.items():
    got = info.hparams[name]
    kind = got.WhichOneof('kind')
    if isinstance(value, str):
      assert kind == 'string_value' and got.string_value == value, name
    else:  # torch's hparams writes a bool as the number 0 or 1
      assert kind == 'number_value' and got.number_value == value, name
