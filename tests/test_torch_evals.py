"""The port's checkpoint evaluation against the JAX package, float32 on the
CPU: `EvalExperiment` on a `ckpt-N.flax` that the JAX package wrote, the
ELBO with shared encoder logits, the dense VLB on its t-grid, the npz/npy
sources and the one-time eval iterator, and the train, eval, sample,
export and `eval_bpd` command lines end to end.

Parameters come from one flax init of the tiny config; the JAX side draws
its noise through the patched, shape-seeded `jax.random` of
`parity_helpers.frozen_randomness`, and the port is handed the same arrays.
"""

import functools
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu import compat as jax_compat
from mulan_tpu.configs import tiny_synthetic as jax_tiny_synthetic
from mulan_tpu.data import pipeline
from mulan_tpu_torch import compat, configs, data, eval_bpd, main
from mulan_tpu_torch.evals import vlb
from mulan_tpu_torch.evals.harness import EvalExperiment
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.train.loop import Experiment
from mulan_tpu_torch.utils import msgpack
from parity_helpers import frozen_randomness
from torch_port_helpers import (mulan_pair, shaped_gamma, shaped_normal,
                                to_torch)

# The ELBO's summed terms, as in tests/test_torch_model.py: float32 on both
# sides, per-pixel differences of 1e-5 summed over an example, in nats.
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3
B = 2


@pytest.fixture(scope='module')
def pair():
  """(flax model, flax params, the port's MuLAN with them), tiny_synthetic."""
  return mulan_pair(configs.tiny_synthetic().model, batch=B)


def _images(n, seed=0):
  shape = configs.tiny_synthetic().model.image_shape
  return np.random.RandomState(seed).randint(
      0, 256, size=(n, *shape)).astype(np.uint8)


def _jax_elbo(model, params, images, t, encoder_logits=None):
  """JAX's ELBO at times t, jitted (eagerly it takes seconds of op-by-op
  dispatch); the frozen jax.random draws its noise at trace time."""
  b = images.shape[0]
  return jax.jit(lambda p, x, tt, logits: model.apply(
      {'params': p}, x, jnp.zeros((b,), jnp.int32), jnp.zeros((b,)), 0, tt,
      rngs={'sample': jax.random.PRNGKey(0)}, deterministic=True,
      method=model.elbo, encoder_logits=logits))(
          params, jnp.asarray(images), jnp.asarray(t), encoder_logits)


def _noise(cfg, rows):
  """What the frozen jax.random draws in an ELBO of `rows` rows."""
  eps = to_torch(shaped_normal((rows, *cfg.image_shape)))
  return dict(eps0=eps, eps=eps, latent_noise=to_torch(shaped_gamma(
      1.0 / cfg.latent_k, (latents.N_GAMMA_TERMS, rows, cfg.latent_size))))


def _assert_elbo_close(got, want):
  for name in ('loss_recon', 'loss_klz', 'loss_diff'):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)),
                               rtol=ELBO_RTOL, atol=ELBO_ATOL, err_msg=name)


class _Calls:
  """A forward hook that records the batch size of every call."""

  def __init__(self, module):
    self.sizes = []
    self.handle = module.register_forward_hook(
        lambda m, args, out: self.sizes.append(args[0].shape[0]))


def test_eval_experiment_reads_a_jax_written_ckpt(pair, tmp_path,
                                                  monkeypatch):
  """A `ckpt-7.flax` written by flax's `to_bytes` from JAX's
  `export_params` (no orbax, no JAX Experiment): the port's codec gives
  `msgpack_restore`'s leaves, EvalExperiment puts the EMA weights in both
  slots, and its ELBO is JAX's on the same noise."""
  model, params, _ = pair
  ema = jax.tree.map(lambda p: p * 0.9 + 0.01, params)
  path = tmp_path / 'ckpt-7.flax'
  path.write_bytes(flax.serialization.to_bytes({
      'step': np.int64(7), 'params': jax_compat.export_params(params),
      'ema_params': jax_compat.export_params(ema)}))
  raw = path.read_bytes()
  got, want = msgpack.restore(raw), flax.serialization.msgpack_restore(raw)
  assert got.keys() == want.keys() and int(got['step']) == 7
  flat_got, flat_want = compat.flatten(got), compat.flatten(want)
  assert list(flat_got) == list(flat_want)
  for key, value in flat_want.items():
    assert flat_got[key].dtype == value.dtype, key
    np.testing.assert_array_equal(flat_got[key], value, err_msg=key)

  cfg = configs.tiny_synthetic()
  for where, number in ((str(path), None), (str(tmp_path), None),
                        (str(tmp_path), 7)):
    ex = EvalExperiment(cfg, where, number, device='cpu')
    assert ex.checkpoint_step == 7
  for name, value in ex.state.params.items():
    assert torch.equal(value.detach(), ex.state.ema_params[name]), name
  live = compat.reference_state_dict(got['params'], cfg.model)
  assert not torch.equal(ex.state.params['gamma.dense_1.weight'],
                         live['gamma.dense_1.weight'])

  images = _images(B)
  t = np.array([0.2, 0.7], np.float32)
  frozen_randomness(monkeypatch)
  jax_out = _jax_elbo(model, ema, images, t)
  with torch.no_grad():
    out = ex.state.ema_model.elbo(torch.from_numpy(images), to_torch(t),
                                  **_noise(cfg.model, B))
  _assert_elbo_close(out, jax_out)

  scalars = ex.test(data.one_time_eval_iterator(
      _images(8), np.zeros(8), batch_size=4))
  assert np.isfinite(scalars['eval_bpd'])
  emb = latents.deterministic_embedding(1, cfg.model.latent_size,
                                        cfg.model.latent_k)[0]
  assert ex.conditional_samples(emb, 4, T=2).shape == (4, 8, 8, 3)
  assert ex.random_samples(4, T=2).dtype == np.uint8


def test_elbo_with_encoder_logits_matches_jax(pair, monkeypatch):
  """`apply_encoder` and `elbo(encoder_logits=...)` against JAX's: given
  logits, the encoder UNet does not run, and its own logits give the ELBO
  without them."""
  model, params, port = pair
  cfg = port.config
  images = _images(B, seed=1)
  t = np.array([0.1, 0.6], np.float32)
  jax_logits = model.apply({'params': params}, jnp.asarray(images),
                           method=model.apply_encoder)
  with torch.no_grad():
    logits = port.apply_encoder(torch.from_numpy(images))
  np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                             rtol=1e-4, atol=1e-5)
  frozen_randomness(monkeypatch)
  want = _jax_elbo(model, params, images, t,
                   encoder_logits=jnp.asarray(logits.numpy()))
  calls = _Calls(port.encoder_model)
  with torch.no_grad():
    got = port.elbo(torch.from_numpy(images), to_torch(t),
                    encoder_logits=logits, **_noise(cfg, B))
    assert calls.sizes == []
    plain = port.elbo(torch.from_numpy(images), to_torch(t),
                      **_noise(cfg, B))
  assert calls.sizes == [B]
  _assert_elbo_close(got, want)
  for name in ('loss_recon', 'loss_klz', 'loss_diff'):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               getattr(plain, name).numpy(), rtol=1e-6,
                               err_msg=name)


def test_dense_bpd_matches_jax_elbo_on_the_grid(pair, monkeypatch):
  """Per-image dense bpd: JAX's ELBO on the images repeated over
  t_j = (u_i + j / n) mod 1 (image-major, `vlb.py:131-147`), averaged over
  j, with the encoder run once per image."""
  model, params, port = pair
  cfg, n = port.config, 4
  images = _images(B, seed=2)
  u = np.array([0.375, 0.81], np.float32)
  grid = np.mod(u[:, None] + np.arange(n) / n, 1.0).astype(np.float32)
  frozen_randomness(monkeypatch)
  out = _jax_elbo(model, params, np.repeat(images, n, axis=0),
                  grid.reshape(-1))
  nats = out.loss_recon + out.loss_klz + out.loss_diff
  want = np.asarray(nats).reshape(B, n).mean(1) / (cfg.n_pixels * np.log(2))
  calls = _Calls(port.encoder_model)
  with torch.no_grad():
    got = vlb.dense_chunk_bpd(port, torch.from_numpy(images), n,
                              u=to_torch(u), **_noise(cfg, B * n))
  assert calls.sizes == [B]
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)

  # The estimator: chunks of 512 // n_timesteps images, the encoder once
  # a chunk, per-image values averaged.
  calls.sizes.clear()
  batches = [_images(8, seed=3)[:5], _images(8, seed=4)[:3]]
  gen = torch.Generator().manual_seed(0)
  bpd = vlb.eval_bpd_dense(port, batches, n_timesteps=128, generator=gen)
  assert calls.sizes == [4, 1, 3] and np.isfinite(bpd)
  calls.sizes.clear()
  again = vlb.eval_bpd_dense(port, batches, n_timesteps=16,
                             images_per_chunk=2, max_batches=1,
                             generator=torch.Generator().manual_seed(0))
  assert calls.sizes == [2, 2, 1]
  assert abs(again - bpd) < 0.05 * bpd


def test_npz_and_npy_sources_match_pipeline(tmp_path):
  """`npz:<dir>` and `npy:<dir>` (written by the JAX package's
  `export_npy_memmap`), the one-time eval iterator and
  `create_one_time_eval_dataset` against `mulan_tpu/data/pipeline.py`."""
  rs = np.random.RandomState(0)
  splits = {s: (rs.randint(0, 256, size=(n, 8, 8, 3)).astype(np.uint8),
                rs.randint(0, 10, size=n)) for s, n in (('train', 37),
                                                        ('eval', 21))}
  npz, npy = tmp_path / 'npz', tmp_path / 'npy'
  os.makedirs(npz)
  for split, (images, labels) in splits.items():
    np.savez(npz / f'{split}.npz', images=images, labels=labels)
    pipeline.export_npy_memmap(pipeline.ArraySource(images, labels),
                               str(npy), split)
  np.savez(npz / 'nolabels.npz', images=splits['eval'][0])
  for dataset, names in ((f'npz:{npz}', ('train', 'eval', 'nolabels')),
                         (f'npy:{npy}', ('train', 'eval'))):
    for split in names:
      images, labels = data.source(dataset, split, (8, 8, 3))
      want = pipeline.load_source(dataset, split, image_shape=(8, 8, 3))
      np.testing.assert_array_equal(images, want.images)
      np.testing.assert_array_equal(labels, want.labels)
      assert images.dtype == np.uint8 and labels.dtype == np.int32
      if dataset.startswith('npy'):
        assert isinstance(images, np.memmap)
      got = list(data.one_time_eval_iterator(images, labels, batch_size=8))
      ref = list(pipeline.one_time_eval_iterator(want, batch_size=8))
      assert len(got) == len(ref) == len(images) // 8
      for g, w in zip(got, ref):
        assert g.keys() == w.keys()
        for key in w:
          np.testing.assert_array_equal(g[key], w[key], err_msg=key)
          assert g[key].dtype == w[key].dtype, key

  cfg = configs.replace(configs.tiny_synthetic(),
                        data={'dataset': f'npy:{npy}'})
  jax_cfg = jax_tiny_synthetic.get_config()
  jax_cfg.data.dataset = f'npy:{npy}'
  for batch_size in (None, 5):
    got = list(data.create_one_time_eval_dataset(cfg, batch_size))
    ref = list(pipeline.create_one_time_eval_dataset(jax_cfg, batch_size))
    assert len(got) == len(ref) > 0
    for g, w in zip(got, ref):
      for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
  with pytest.raises(NotImplementedError, match='not ported'):
    data.source('cifar10', 'eval', (32, 32, 3))


def test_command_lines_train_resume_and_evaluate_on_cpu(tmp_path, capsys,
                                                        monkeypatch):
  """`main --mode train` stopped after step 2 (a checkpoint every 2 steps)
  and run again resumes at step 2 and ends at step 4; then `eval_bpd`
  dense and sparse, `--mode eval` and `--mode sample` on the checkpoint,
  and the same dense bpd from its `ckpt-4.flax` export. The in-training
  sampler runs 2 steps instead of 1000."""
  monkeypatch.setenv('COMPOSER_RUN_NAME', 'run')
  monkeypatch.delenv('SLURM_JOB_ID', raising=False)
  monkeypatch.setattr(Experiment, 'draw_samples', functools.partialmethod(
      Experiment.draw_samples, T=2))
  args = ['--mode=train', '--config=mulan_tpu/configs/tiny_synthetic.py',
          f'--workdir={tmp_path}', '--device=cpu',
          '--config.training.steps_per_save=2']
  workdir = tmp_path / 'tiny_synthetic' / 'run-steps_per_save=2'
  ckpts = workdir / 'checkpoints'

  step = Experiment.train_step

  def stop_at_3(self, batch, noise=None):
    if self.state.step == 2:
      raise KeyboardInterrupt
    return step(self, batch, noise)

  with monkeypatch.context() as m:
    m.setattr(Experiment, 'train_step', stop_at_3)
    with pytest.raises(KeyboardInterrupt):
      main.main(args)
  assert sorted(os.listdir(ckpts)) == ['ckpt_2.pt']
  capsys.readouterr()
  main.main(args)
  out = capsys.readouterr().out
  assert sorted(os.listdir(ckpts)) == ['ckpt_2.pt', 'ckpt_4.pt']
  logged = [line.split(',')[0] for line in out.splitlines()
            if line[:1].isdigit()]
  assert logged and set(logged) == {'4'}, out  # log and eval at step 4

  def bpd_of(*extra):
    eval_bpd.main(['--config=tiny_synthetic', '--device=cpu',
                   '--n_timesteps=4', *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    bpd, ckpt = line.removeprefix('Test BPD:').split(' ckpt:')
    assert int(ckpt) == 4, line
    return float(bpd)

  dense = bpd_of(f'--checkpoint_directory={ckpts}',
                 '--bpd_eval_method=dense')
  sparse = bpd_of(f'--checkpoint_directory={ckpts}',
                  '--bpd_eval_method=sparse')
  assert np.isfinite(dense) and np.isfinite(sparse)
  assert abs(dense - sparse) < 0.2 * dense
  compat.main(['--mode=export', f'--checkpoint={ckpts}',
               f'--output={tmp_path / "ref"}'])
  flax_path = tmp_path / 'ref' / 'ckpt-4.flax'
  assert flax_path.exists()
  assert bpd_of(f'--checkpoint_directory={flax_path}',
                '--bpd_eval_method=dense') == dense

  main.main(['--mode=eval', '--config=tiny_synthetic', '--device=cpu',
             f'--workdir={tmp_path / "eval"}', f'--checkpoint={ckpts}'])
  assert (tmp_path / 'eval' / 'eval' / 'samples_4.png').exists()
  main.main(['--mode=sample', '--config=tiny_synthetic', '--device=cpu',
             f'--workdir={tmp_path / "samples"}', f'--checkpoint={flax_path}',
             '--sample_T=2', '--sample_batch=4'])
  png = (tmp_path / 'samples' / 'samples_ckpt4_ancestral.png').read_bytes()
  assert png.startswith(b'\x89PNG\r\n\x1a\n')
