"""The port's baseline VDM through its entry points, against the JAX package
where it has a counterpart, float32 on the CPU: `Experiment` steps against a
JAX loop, exact resume, the `ckpt-N.flax` of a VDM both ways,
`EvalExperiment` with the sparse and dense VLB, an RK4 ODE likelihood and the
ODE sampler, and the train, eval, sample, export and `eval_bpd` command lines
on `--config=vdm_cifar10` cut to a tiny size.

Parameters are the port's seeded `init_params` of a tiny VDM, handed to flax
through `params.to_flax`; the JAX side draws its noise through the patched,
shape-seeded `jax.random` of `parity_helpers.frozen_randomness`, its dropout
masks through a patched `_hw_mask`, and the port is handed the same arrays.
"""

import dataclasses
import functools
import math
import os

import flax.serialization
from flax.traverse_util import flatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu import compat as jax_compat
from mulan_tpu.evals import nll_ode as jax_nll
from mulan_tpu.models import vdm as jax_vdm
from mulan_tpu.ops.ode import odeint_rk4 as jax_rk4
from mulan_tpu.train import optimizer as jax_optimizer
from mulan_tpu.train.state import TrainState as JaxTrainState
from mulan_tpu_torch import compat, configs, eval_bpd, main, params
from mulan_tpu_torch.evals import nll_ode, vlb
from mulan_tpu_torch.evals.harness import EvalExperiment
from mulan_tpu_torch.models import VDM
from mulan_tpu_torch.ops import ode
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train import optimizer as port_optimizer
from mulan_tpu_torch.train.loop import Experiment
from parity_helpers import frozen_randomness
from torch_port_helpers import (jax_config, seeded_pair, shaped_normal,
                                to_torch)
from test_torch_train import GRAD_RTOL, _inject_masks, _jax_loss_and_grads
from test_torch_vdm import TINY

B = 4
# The ELBO's summed terms (tests/test_torch_evals.py) and an ODE solve's log
# p, log q and KL (tests/test_torch_nll_ode.py).
ELBO_RTOL, LIKELIHOOD_RTOL = 1e-4, 1e-4
# The tiny VDM on the command line: vdm_cifar10 with TINY's sizes.
TINY_ARGS = ['--config=vdm_cifar10', '--config.model.image_size=8',
             '--config.model.sm_n_embd=16', '--config.model.sm_n_layer=2',
             '--config.model.compute_dtype=float32',
             '--config.model.use_kernels=False',
             '--config.data.dataset=synthetic',
             '--config.data.synthetic_examples=64',
             '--config.training.batch_size_train=4',
             '--config.training.batch_size_eval=8', '--device=cpu']


@pytest.fixture(scope='module')
def pair():
  """(flax VDM, its params, the port's VDM with them), TINY."""
  return seeded_pair(TINY, vdm_type='vdm')


def _config(**model):
  """vdm_cifar10 cut to TINY with the kernel flag on (JAX's `hw_dropout`
  and Pallas decoder, the port's mask functions), a one-step warm-up and
  lr 2e-3, so that every step moves the parameters, the EMA and the
  moments."""
  cfg = configs.vdm_cifar10()
  return configs.replace(
      cfg, model=dataclasses.asdict(dataclasses.replace(
          TINY, use_kernels=True, **model)),
      data={'dataset': 'synthetic', 'synthetic_examples': 64},
      training={'num_steps_lr_warmup': 1, 'batch_size_train': B,
                'batch_size_eval': B},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-3))


def _batch(seed):
  rs = np.random.RandomState(seed)
  return {'images': rs.randint(0, 256, size=(B, *TINY.image_shape))
                      .astype(np.uint8),
          'labels': np.zeros((B,), np.int32),
          'conditioning': np.zeros((B,), np.uint8)}


def _port_noise():
  """What the frozen jax.random draws inside the JAX ELBO."""
  eps = to_torch(shaped_normal((B, *TINY.image_shape)))
  return dict(
      t=to_torch(jnp.mod(0.375 + jnp.arange(0.0, 1.0, step=1.0 / B), 1.0)),
      eps0=eps, eps=eps, dropout_seed=0)


def test_experiment_train_steps_match_jax(pair, monkeypatch):
  """Three steps of the port's Experiment on vdm_cifar10 (cut to TINY)
  against a JAX loop of `Experiment.loss_fn` + `TrainState.apply_gradients`
  on the same batches, frozen noise and injected dropout masks, with the
  tolerances of tests/test_torch_train.py's MuLAN loop."""
  _, jax_params, port = pair
  cfg = _config()
  ex = Experiment(cfg, device='cpu', state=port.state_dict())
  assert isinstance(ex.model, VDM) and isinstance(ex.state.ema_model, VDM)
  # The two groups: the score UNet against the schedule (no encoder).
  halved = port_optimizer.make_optimizer(
      ex.model.named_parameters(), cfg.optimizer, lambda count: 1.0, 0.5)
  scales = {id(p): g['lr_scale'] for g in halved.adamw.param_groups
            for p in g['params']}
  assert {n.split('.')[0] for n, p in ex.model.named_parameters()
          if scales[id(p)] == 0.5} == {'gamma'}
  model = jax_vdm.VDM(jax_config(cfg.model))
  frozen_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  opt = cfg.optimizer
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': dataclasses.asdict(opt.args)},
      jax_optimizer.make_lr_schedule(opt.learning_rate,
                                     cfg.training.num_steps_lr_warmup,
                                     cfg.training.num_steps_train,
                                     opt.lr_decay))
  jstate = JaxTrainState.create(apply_fn=None, params=jax_params, tx=tx)
  # Jitted once for the three steps (eagerly, the interpreted Pallas
  # kernels dispatch op by op); the step enters only the unused `step`.
  jax_step = jax.jit(lambda p, b: _jax_loss_and_grads(model, p, cfg, b, 0))
  for step in range(3):
    batch = _batch(10 + step)
    (bpd_want, _), grads = jax_step(jstate.params, batch)
    jstate = jstate.apply_gradients(grads=grads, ema_rate=opt.ema_rate)
    scalars = ex.train_step(batch, noise=_port_noise())
    np.testing.assert_allclose(scalars['bpd'].item(), float(bpd_want),
                               rtol=1e-4, err_msg=f'step {step}')
  assert ex.state.step == 3
  # As in tests/test_torch_train.py: Adam moves an element whose gradient
  # is near zero by up to lr a step in a direction its last bits decide.
  move = 2 * opt.learning_rate
  for mine, theirs in ((ex.state.params, jstate.params),
                       (ex.state.ema_params, jstate.ema_params)):
    want = params.from_flax({k: np.asarray(v) for k, v in
                             flatten_dict(theirs, sep='/').items()})
    excess = torch.cat([
        ((mine[k].detach() - w).abs() - GRAD_RTOL * w.abs()).flatten()
        for k, w in want.items()])
    assert excess.max() <= move, excess.max()
    assert (excess > 0.1 * move).double().mean() <= 1e-2
  for name in ('gamma.l1.kernel', 'gamma.l1.bias', 'gamma.l3.kernel'):
    assert not torch.equal(ex.state.params[name],
                           port.state_dict()[name]), name


def test_resume_is_bit_exact(pair, tmp_path):
  """Four steps straight against two, a checkpoint, a fresh Experiment
  restored from it and two more: params, EMA, AdamW moments and counts bit
  for bit; then the last state's `ckpt-N.flax` export is the bytes of
  flax's `to_bytes` of JAX's `export_params`, and reads back."""
  cfg = _config()
  state = pair[2].state_dict()
  batches = [_batch(20 + i) for i in range(4)]
  straight = Experiment(cfg, device='cpu', state=state)
  bpds = [straight.train_step(b)['bpd'] for b in batches]
  first = Experiment(cfg, device='cpu', state=state)
  resumed = [first.train_step(b)['bpd'] for b in batches[:2]]
  mngr = ckpt_lib.CheckpointManager(tmp_path / 'ckpts')
  mngr.save(2, first.state)
  second = Experiment(cfg, device='cpu', state=state)
  mngr.restore(second.state)
  resumed += [second.train_step(b)['bpd'] for b in batches[2:]]
  assert all(torch.equal(a, b) for a, b in zip(bpds, resumed))
  for name in ('params', 'ema_params'):
    for k, v in getattr(straight.state, name).items():
      assert torch.equal(getattr(second.state, name)[k], v), (name, k)
  for a, b in zip(straight.state.optimizer.adamw.state_dict()['state']
                  .values(), second.state.optimizer.adamw.state_dict()
                  ['state'].values()):
    assert all(torch.equal(a[k], b[k]) for k in a)

  mngr.save(4, second.state)
  path = compat.export_reference_checkpoint(str(tmp_path / 'ckpts'),
                                            str(tmp_path / 'ref'))
  assert os.path.basename(path) == 'ckpt-4.flax'

  def tree(tensors):
    return jax_compat.export_params(compat.unflatten(
        params.to_flax(tensors)))
  want = flax.serialization.to_bytes({
      'step': np.int64(4), 'params': tree(second.state.params),
      'ema_params': tree(second.state.ema_params)})
  with open(path, 'rb') as f:
    assert f.read() == want
  ev = EvalExperiment(cfg, path, device='cpu')
  assert ev.checkpoint_step == 4 and isinstance(ev.state.ema_model, VDM)
  for k, v in second.state.ema_params.items():
    assert torch.equal(ev.state.ema_params[k], v), k
  step = compat.import_reference_checkpoint(cfg, path,
                                            str(tmp_path / 'imported'),
                                            device='cpu')
  back = ckpt_lib.CheckpointManager(
      tmp_path / 'imported' / 'checkpoints').restore_dict()
  assert step == 4 and back['step'] == 4
  for k, v in second.state.params.items():
    assert torch.equal(back['params'][k], v), k
  with pytest.raises(ValueError, match='does not match'):  # a MuLAN
    EvalExperiment(configs.tiny_synthetic(), path, device='cpu')


def _jax_elbo(model, params_jax, images, t):
  b = images.shape[0]
  return jax.jit(lambda p, x, tt: model.apply(
      {'params': p}, x, jnp.zeros((b,), jnp.int32), jnp.zeros((b,)), 0, tt,
      rngs={'sample': jax.random.PRNGKey(0)}, deterministic=True,
      method=model.elbo))(params_jax, jnp.asarray(images), jnp.asarray(t))


def test_sparse_and_dense_vlb_through_eval_experiment(pair, tmp_path,
                                                       monkeypatch):
  """EvalExperiment on a `ckpt-N.flax` that flax's `to_bytes` wrote from
  JAX's `export_params`: the dense per-image bpd on the grid against JAX's
  ELBO (the VDM takes the plain path: no encoder to share), the sparse VLB,
  `test` and both samplers."""
  model, params_jax, _ = pair
  ema = jax.tree.map(lambda p: p * 0.9 + 0.01, params_jax)
  path = tmp_path / 'ckpt-5.flax'
  path.write_bytes(flax.serialization.to_bytes({
      'step': np.int64(5), 'params': jax_compat.export_params(params_jax),
      'ema_params': jax_compat.export_params(ema)}))
  ex = EvalExperiment(_config(), str(path), device='cpu')
  port = ex.state.ema_model
  n = 4
  images = np.random.RandomState(30).randint(
      0, 256, size=(2, *TINY.image_shape)).astype(np.uint8)
  u = np.array([0.375, 0.81], np.float32)
  grid = np.mod(u[:, None] + np.arange(n) / n, 1.0).astype(np.float32)
  frozen_randomness(monkeypatch)
  out = _jax_elbo(model, ema, np.repeat(images, n, axis=0), grid.reshape(-1))
  nats = out.loss_recon + out.loss_klz + out.loss_diff
  want = np.asarray(nats).reshape(2, n).mean(1) / (TINY.n_pixels * np.log(2))
  eps = to_torch(shaped_normal((2 * n, *TINY.image_shape)))
  with torch.no_grad():
    got = vlb.dense_chunk_bpd(port, torch.from_numpy(images), n,
                              u=to_torch(u), eps0=eps, eps=eps)
  np.testing.assert_allclose(got.numpy(), want, rtol=ELBO_RTOL)

  batches = [np.random.RandomState(31).randint(
      0, 256, size=(6, *TINY.image_shape)).astype(np.uint8)]
  gen = torch.Generator().manual_seed(0)
  dense = vlb.eval_bpd_dense(port, batches, n_timesteps=8, generator=gen)
  sparse = vlb.eval_bpd_sparse(port, batches, generator=gen)
  assert np.isfinite(dense) and np.isfinite(sparse)
  assert abs(dense - sparse) < 0.3 * dense
  scalars = ex.test([_batch(32), _batch(33)])
  assert np.isfinite(scalars['eval_bpd']) and scalars['eval_bpd_latent'] > 0
  assert ex.random_samples(4, T=2).shape == (4, *TINY.image_shape)
  assert ex.draw_samples(4, T=2).shape == (16, 16, 3)


ODE_CFG = dataclasses.replace(TINY, with_fourier_features=False)
SHAPE = (2, *ODE_CFG.image_shape)
IMAGES = np.random.RandomState(40).randint(0, 256, size=SHAPE).astype(
    np.uint8)
U_TN = np.clip(np.random.RandomState(41).standard_normal(SHAPE), -3,
               3).astype(np.float32)
PROBE = (2 * np.random.RandomState(42).randint(0, 2, size=SHAPE)
         - 1).astype(np.float32)


@pytest.fixture(scope='module')
def ode_pair():
  """As `pair`, without the UNet's Fourier features (a 2-step RK4 would
  amplify their float32 rounding, tests/test_torch_nll_ode.py)."""
  return seeded_pair(ODE_CFG, vdm_type='vdm')


def test_rk4_likelihood_and_ode_sampler_match_jax(ode_pair, monkeypatch):
  """log p, log q(eps) and the latent KL (0: no latent) of a 2-step RK4
  solve against JAX's jitted likelihood with the dequantization draw and
  the probe injected on both sides; then the ODE sampler with DoPri5
  swapped for a 2-step RK4 on both sides, conditioned on zeros."""
  model, params_jax, port = ode_pair
  monkeypatch.setattr(jax.random, 'truncated_normal',
                      lambda *a, **k: jnp.asarray(U_TN))
  monkeypatch.setattr(jax_nll, '_hutchinson_noise',
                      lambda *a: jnp.asarray(PROBE))
  want = jax.jit(jax_nll.make_ode_likelihood_fn(
      model, model.config, odeint=functools.partial(jax_rk4, num_steps=2)))(
          params_jax, jax.random.PRNGKey(0), IMAGES)
  with torch.inference_mode():
    got = nll_ode.make_ode_likelihood_fn(
        port, odeint=functools.partial(ode.odeint_rk4, num_steps=2))(
            IMAGES, u=U_TN, probe=PROBE)
  for name, a, b in zip(('log_p', 'log_q_eps', 'aux'), got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                               rtol=LIKELIHOOD_RTOL, err_msg=name)
  assert not got[2].any() and got[3]['nfe'] == 8

  frozen_randomness(monkeypatch)
  monkeypatch.setattr(jax_nll, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      jax_rk4(f, y, t0, t1, num_steps=2)))
  monkeypatch.setattr(nll_ode, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      ode.odeint_rk4(f, y, t0, t1, num_steps=2)))
  n = 3
  want, want_nfe = jax.jit(lambda p: jax_nll.make_ode_sample_fn(
      model, model.config)(p, jax.random.PRNGKey(0), n))(params_jax)
  z0, nfe = nll_ode.make_ode_sample_fn(port)(
      n, prior=shaped_normal((n, *ODE_CFG.image_shape)))
  assert nfe == int(want_nfe) == 8
  want = np.asarray(want, np.float64)
  assert np.abs(z0.numpy() - want).max() <= (
      LIKELIHOOD_RTOL * np.abs(want).max())


def test_command_lines_run_the_vdm_on_cpu(tmp_path, capsys, monkeypatch):
  """`main --mode train --config=vdm_cifar10` (tiny overrides, 2 steps in
  super-steps of 1, a checkpoint at each); `eval_bpd` sparse, dense and ode (rk4) on the
  checkpoints and on their `ckpt-2.flax` export; `--mode eval`; `--mode
  sample` ancestral and ode. The in-training sampler runs 2 steps."""
  monkeypatch.setenv('COMPOSER_RUN_NAME', 'run')
  monkeypatch.delenv('SLURM_JOB_ID', raising=False)
  monkeypatch.setattr(Experiment, 'draw_samples', functools.partialmethod(
      Experiment.draw_samples, T=2))
  # One step a super-step (JAX's config has 1000), set on the config
  # itself: one more override would make the run's name too long a path.
  config_fn = configs.CONFIGS['vdm_cifar10']
  monkeypatch.setitem(configs.CONFIGS, 'vdm_cifar10', lambda: configs.replace(
      config_fn(), training={'substeps': 1}))
  main.main(['--mode=train', f'--workdir={tmp_path}', *TINY_ARGS,
             '--config.training.num_steps_train=2',
             '--config.training.steps_per_save=1',
             '--config.training.num_steps_eval=1'])
  out = capsys.readouterr().out
  assert 'train_bpd' in out and 'eval_bpd' in out, out
  runs = os.listdir(tmp_path / 'vdm_cifar10')
  ckpts = tmp_path / 'vdm_cifar10' / runs[0] / 'checkpoints'
  assert sorted(os.listdir(ckpts)) == ['ckpt_1.pt', 'ckpt_2.pt']
  compat.main(['--mode=export', f'--checkpoint={ckpts}',
               f'--output={tmp_path / "ref"}'])
  flax_path = tmp_path / 'ref' / 'ckpt-2.flax'

  def bpd_of(where, *extra):
    eval_bpd.main([*TINY_ARGS, f'--checkpoint_directory={where}', *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    bpd, ckpt = line.removeprefix('Test BPD:').split(' ckpt:')
    assert int(ckpt) == 2, line
    return float(bpd)
  bpds = {}
  for method, extra in (('sparse', []), ('dense', ['--n_timesteps=4']),
                        ('ode', ['--solver=rk4', '--rk4_steps=2',
                                 '--n_is=1'])):
    bpds[method] = bpd_of(ckpts, f'--bpd_eval_method={method}', *extra)
    assert math.isfinite(bpds[method]), (method, bpds)
  assert bpd_of(flax_path, '--bpd_eval_method=dense',
                '--n_timesteps=4') == bpds['dense']

  main.main(['--mode=eval', *TINY_ARGS, f'--workdir={tmp_path / "eval"}',
             f'--checkpoint={ckpts}'])
  assert (tmp_path / 'eval' / 'eval' / 'samples_2.png').exists()
  for sampler in ('ancestral', 'ode'):
    main.main(['--mode=sample', *TINY_ARGS, f'--sampler={sampler}',
               f'--workdir={tmp_path / "samples"}',
               f'--checkpoint={flax_path}', '--sample_T=2',
               '--sample_batch=4'])
    png = (tmp_path / 'samples' / f'samples_ckpt2_{sampler}.png')
    assert png.read_bytes().startswith(b'\x89PNG\r\n\x1a\n'), sampler
