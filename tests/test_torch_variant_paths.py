"""The port's MuLAN variants through their entry points against the JAX
package's, float32 on the CPU: the parameter tree of every variant (JAX's
init against `from_flax`, `init_params`, the model's `state_dict` and a
`ckpt-N.flax` round trip), train-mode gradients with dropout masks
injected, `Experiment` steps with labels, a dense-VLB chunk with labels,
the ancestral sampler, `generate_x` with `sample_softmax` and
`apply_gamma` (the ODE paths are in tests/test_torch_variant_ode.py).

Models are the port's seeded `init_params` of the tiny config with the
zero-initialized leaves perturbed, handed to flax through
`params.to_flax`; noise comes from the frozen `jax.random` of
`torch_port_helpers.frozen_latent_randomness`, handed to the port.
"""

import dataclasses
import types

import flax
from flax.traverse_util import flatten_dict, unflatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu import compat as jax_compat
from mulan_tpu.models import build_model as build_jax_model
from mulan_tpu.ops import dropout as jax_dropout
from mulan_tpu.train import loop as jax_loop
from mulan_tpu.train import optimizer as jax_optimizer
from mulan_tpu.train.state import TrainState as JaxTrainState
from mulan_tpu_torch import compat, configs, params
from mulan_tpu_torch.evals import vlb
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.models.mulan import MuLAN
from mulan_tpu_torch.ops import dropout as drop_ops
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import Experiment, create_train_state
from parity_helpers import shape_seed
from torch_port_helpers import (VARIANTS, frozen_latent_randomness,
                                jax_config, latent_noise_for, seeded_pair,
                                shaped_gumbel, shaped_normal, to_torch)

B = 4
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3
# Train-mode gradients, as tests/test_torch_train.py: rtol, and atol as a
# fraction of the model's largest gradient.
GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 2e-4
# The `poly_fixedend` network's leaves and the encoder trunk's one-channel
# head: in float32 their gradients lie further from the float64 result than
# GRAD_ATOL_FRAC on both sides. For the Gaussian model, against the port run
# in float64 (its float casts patched to double), the port's float32
# gradient lies 2.9e-3 of the largest gradient away there and JAX's 1.65e-3
# (the flagship's top-k model, at this test's seed and batch, 2.7 times
# GRAD_ATOL_FRAC too); every other leaf agrees within GRAD_ATOL_FRAC. Those
# leaves are held to the float32 spread.
SPREAD_ATOL_FRAC = 3e-3
SPREAD_LEAVES = ('gamma.dense_', 'encoder_model.trunk.conv_out.')
# Sampler steps, as tests/test_torch_model.py.
RTOL, ATOL = 1e-4, 1e-5


def _images(cfg, n=B, seed=0):
  rs = np.random.RandomState(seed)
  return rs.randint(0, 256, size=(n, *cfg.image_shape)).astype(np.uint8)


def _labels_and_conditioning(n=B, seed=11):
  rs = np.random.RandomState(seed)
  return (rs.randint(0, 10, size=n).astype(np.int32),
          rs.randint(0, 2, size=n).astype(np.uint8))


# -- parameter trees ----------------------------------------------------------


@pytest.mark.parametrize('name', list(VARIANTS))
def test_param_tree_matches_jax_init(name, tmp_path):
  """JAX's init tree of the variant (no `encoder_model` without
  `reparam_type` 'true', the gamma network and the UNet's `dense0` sized
  for its embedding and conditioning) is exactly what `from_flax` gives,
  what `init_params` makes and what the model holds, and loads strictly;
  the reference layout the port exports is JAX's `export_params` of it,
  and a `ckpt-N.flax` the port writes reads back bit for bit."""
  cfg = tiny_config(**VARIANTS[name])
  model = build_jax_model('mulan_velocity', jax_config(cfg))
  tree = jax.eval_shape(lambda r: model.init(
      {'params': r, 'sample': r}, jnp.zeros((2, *cfg.image_shape),
                                            jnp.uint8),
      jnp.zeros((2,), jnp.int32), jnp.zeros((2,)), step=-1.0)['params'],
      jax.random.PRNGKey(0))
  flat = {k: np.zeros(v.shape, np.float32)
          for k, v in flatten_dict(tree, sep='/').items()}
  assert ('encoder_model' in tree) == (cfg.reparam_type == 'true')
  want = {k: tuple(v.shape) for k, v in params.from_flax(flat).items()}
  with torch.device('meta'):
    held = {k: tuple(v.shape) for k, v in MuLAN(cfg).state_dict().items()}
  state = params.init_params(cfg, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  assert held == want
  assert {k: tuple(v.shape) for k, v in state.items()} == want
  MuLAN(cfg).load_state_dict(params.from_flax(flat), strict=True)

  # The reference layout and a ckpt-N.flax through a port checkpoint.
  jax_params = unflatten_dict({tuple(k.split('/')): v for k, v in
                               params.to_flax(state).items()})
  ref = compat.to_reference_params(state)
  assert flax.serialization.to_bytes(ref) == flax.serialization.to_bytes(
      jax_compat.export_params(jax_params))
  config = configs.replace(configs.tiny_synthetic(), model=dataclasses.asdict(
      cfg))
  _, train_state = create_train_state(config, 'cpu', state)
  train_state.step = 7
  ckpt_lib.CheckpointManager(tmp_path / 'ckpts').save(7, train_state)
  path = compat.export_reference_checkpoint(str(tmp_path / 'ckpts'),
                                            str(tmp_path / 'out'))
  back = compat.load_reference_state(path)
  for key in ('params', 'ema_params'):
    restored = compat.reference_state_dict(back[key], cfg)
    assert restored.keys() == state.keys()
    assert all(torch.equal(restored[k], v) for k, v in state.items()), key


def test_learnable_nnet_init_follows_jax():
  """`l1` at gamma_max - gamma_min and gamma_min, the kernels of `l2`,
  `l_int` and `l3` normal(0, 1e-2), the biases 0 (`schedules.py:330-341`);
  `l_int`'s kernel keeps flax's (in, out) layout through from_flax."""
  cfg = tiny_config(gamma_type='learnable_nnet', latent_size=20)
  state = params.init_params(cfg, torch.Generator().manual_seed(0))
  assert state['gamma.l1.kernel'].item() == pytest.approx(18.3)
  assert state['gamma.l1.bias'].item() == pytest.approx(-13.3)
  for layer in ('l2', 'l_int', 'l3'):
    std = state[f'gamma.{layer}.kernel'].std().item()
    assert 0.009 < std < 0.011, (layer, std)
  assert not state['gamma.l2.bias'].any() and not state[
      'gamma.l_int.bias'].any()
  kernel = np.arange(192 * 192, dtype=np.float32).reshape(192, 192)
  got = params.from_flax({'gamma/l_int/kernel': kernel})
  np.testing.assert_array_equal(got['gamma.l_int.kernel'].numpy(), kernel)
  assert params.to_flax(got)['gamma/l_int/kernel'].shape == (192, 192)


# -- train-mode gradients and Experiment steps --------------------------------


def _fake_mask(shape, rate):
  """A shape-seeded numpy keep mask with values {0, 1 / (1 - p_eff)}."""
  rs = np.random.RandomState(shape_seed(shape) ^ 0x0D0D)
  p = jax_dropout.effective_rate(rate)
  return ((rs.uniform(size=shape) >= p) / (1.0 - p)).astype(np.float32)


def _inject_masks(monkeypatch):
  """The same dropout masks on both sides, by the NHWC shape."""

  def jax_mask(seed, shape, rate, dtype):
    del seed
    return jnp.asarray(_fake_mask(tuple(shape), rate), dtype)

  def port_mask(seed, site, shape, rate, dtype, device=None):
    del seed, site
    b, c, h, w = shape
    return torch.from_numpy(_fake_mask((b, h, w, c), rate)).permute(
        0, 3, 1, 2).to(dtype=dtype, device=device)

  monkeypatch.setattr(jax_dropout, '_hw_mask', jax_mask)
  monkeypatch.setattr(drop_ops, 'dropout_mask', port_mask)
  monkeypatch.setattr(drop_ops, 'dropout_mask_plain', port_mask)


def _train_config(overrides):
  """tiny_synthetic with the variant, the kernel flag on (JAX's
  `hw_dropout`, the port's mask functions), a one-step warm-up, lr 2e-3."""
  cfg = configs.tiny_synthetic()
  return configs.replace(
      cfg, model=dict(use_kernels=True, **overrides),
      training={'num_steps_lr_warmup': 1},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-3))


def _batch(cfg, seed):
  labels, conditioning = _labels_and_conditioning(seed=seed)
  return {'images': _images(cfg.model, seed=seed), 'labels': labels,
          'conditioning': conditioning}


def _port_noise(cfg):
  """What the frozen jax.random draws inside the JAX train-mode ELBO."""
  m = cfg.model
  eps = to_torch(shaped_normal((B, *m.image_shape)))
  return dict(t=to_torch(jnp.mod(0.375 + jnp.arange(0.0, 1.0, 1.0 / B), 1.0)),
              eps0=eps, eps=eps, dropout_seed=0,
              latent_noise=latent_noise_for(m, B))


def _jax_loss_and_grads(cfg, jax_params):
  """JAX's train-mode `Experiment.loss_fn` and its gradient, jitted (the
  interpret-mode Pallas decoder takes seconds eagerly); (params, batch,
  step) -> ((bpd, scalars), grads)."""
  model = build_jax_model('mulan_velocity', jax_config(cfg.model))
  fake = types.SimpleNamespace(model=model,
                               model_config=jax_config(cfg.model))
  return jax.jit(lambda p, batch, step: jax.value_and_grad(
      lambda q: jax_loop.Experiment.loss_fn(fake, q, batch, step,
                                            jax.random.PRNGKey(0), True),
      has_aux=True)(p))


def _port_and_jax_params(cfg):
  state = params.init_params(cfg.model, torch.Generator().manual_seed(0),
                             perturb_zero_init=0.02)
  return state, unflatten_dict({tuple(k.split('/')): jnp.asarray(v) for k, v
                                in params.to_flax(state).items()})


@pytest.mark.parametrize('name', ['ldm_learnable_nnet', 'gaussian',
                                  'gumbel'])
def test_train_gradients_match_jax(monkeypatch, name):
  """The train-mode loss and every leaf's gradient, dropout on, the
  batch's labels and conditioning fed: the ldm UNet's per-pixel
  conditioning and the learned schedule's unpinned ends, the Gaussian's
  two heads, the Gumbel latent's straight-through gradient."""
  cfg = _train_config(VARIANTS[name])
  state, jax_params = _port_and_jax_params(cfg)
  frozen_latent_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  batch = _batch(cfg, 0)
  (bpd_want, scalars_want), grads_want = _jax_loss_and_grads(
      cfg, jax_params)(jax_params, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, 3)
  ex = Experiment(cfg, device='cpu', state=state)
  bpd, scalars = ex.loss_fn(ex.model, batch, train=True,
                            noise=_port_noise(cfg), step=3)
  bpd.backward()
  for key, value in scalars_want.items():
    np.testing.assert_allclose(scalars[key].item(), float(value), rtol=1e-4,
                               atol=1e-6, err_msg=key)
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(grads_want, sep='/').items()})
  got = {k: p.grad for k, p in ex.model.named_parameters()}
  assert got.keys() == want.keys()
  scale = max(w.abs().max().item() for w in want.values())
  for leaf, w in want.items():
    atol = (SPREAD_ATOL_FRAC if leaf.startswith(SPREAD_LEAVES)
            else GRAD_ATOL_FRAC)
    np.testing.assert_allclose(got[leaf].numpy(), w.numpy(), rtol=GRAD_RTOL,
                               atol=atol * scale, err_msg=leaf)
  if cfg.model.gamma_type == 'learnable_nnet':  # g0 is learned
    assert got['gamma.l1.bias'].abs().item() > 0


@pytest.mark.parametrize('name', ['reparam_none', 'gumbel'])
def test_experiment_steps_with_labels_match_jax(monkeypatch, name):
  """Three `Experiment.train_step`s against a JAX loop of `loss_fn` +
  `apply_gradients` on batches with labels and conditioning, each step's
  ELBO at the state's step before the update; then the updated
  parameters (as in tests/test_torch_train.py)."""
  cfg = _train_config(VARIANTS[name])
  state, jax_params = _port_and_jax_params(cfg)
  frozen_latent_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  opt = cfg.optimizer
  tx = jax_optimizer.make_optimizer(
      {'name': 'adamw', 'args': dataclasses.asdict(opt.args)},
      jax_optimizer.make_lr_schedule(opt.learning_rate,
                                     cfg.training.num_steps_lr_warmup,
                                     cfg.training.num_steps_train,
                                     opt.lr_decay))
  jstate = JaxTrainState.create(apply_fn=None, params=jax_params, tx=tx)
  loss_and_grads = _jax_loss_and_grads(cfg, jax_params)
  ex = Experiment(cfg, device='cpu', state=state)
  steps = []
  forward = ex.model.forward
  monkeypatch.setattr(ex.model, 'forward', lambda *a, **k: (
      steps.append(k['step']), forward(*a, **k))[1])
  for step in range(3):
    batch = _batch(cfg, 10 + step)
    (bpd_want, _), grads = loss_and_grads(
        jstate.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jstate.step)
    jstate = jstate.apply_gradients(grads=grads, ema_rate=opt.ema_rate)
    noise = _port_noise(cfg)
    del noise['t']  # drawn by `forward`, frozen at 0.375 as in JAX
    monkeypatch.setattr(torch, 'rand', lambda shape, **unused: torch.full(
        shape, 0.375))
    monkeypatch.setattr(MuLAN, '_randn', lambda self, shape, gen: to_torch(
        shaped_normal(shape)))
    monkeypatch.setattr(latents, 'latent_variates',
                        lambda c, b, **unused: latent_noise_for(c, b))
    scalars = ex.train_step(batch)
    monkeypatch.undo()
    frozen_latent_randomness(monkeypatch)
    _inject_masks(monkeypatch)
    monkeypatch.setattr(ex.model, 'forward', lambda *a, **k: (
        steps.append(k['step']), forward(*a, **k))[1])
    np.testing.assert_allclose(scalars['bpd'].item(), float(bpd_want),
                               rtol=1e-4, err_msg=f'step {step}')
  assert steps == [0, 1, 2] and ex.state.step == 3
  move = 2 * opt.learning_rate
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(jstate.params, sep='/').items()})
  excess = torch.cat([
      ((ex.state.params[k].detach() - w).abs() - GRAD_RTOL * w.abs())
      .flatten() for k, w in want.items()])
  assert excess.max() <= move, excess.max()
  assert (excess > 0.1 * move).double().mean() <= 1e-2


# -- evaluation, sampling -----------------------------------------------------


class _Calls:
  """A forward hook that records the batch size of every call."""

  def __init__(self, module):
    self.sizes = []
    if module is not None:
      module.register_forward_hook(
          lambda m, args, out: self.sizes.append(args[0].shape[0]))


@pytest.mark.parametrize('name,encoder_rows', [
    ('reparam_none', None), ('gaussian', 'rows'), ('gumbel', 'images')])
def test_dense_chunk_with_labels_matches_jax(monkeypatch, name, encoder_rows):
  """Per-image dense bpd against JAX's ELBO on the images, labels and
  conditioning repeated over the grid, image-major (`vlb.py:131-147`); the
  encoder runs once an image only for a logits encoder (`vlb.py:116-118`),
  and not at all without one."""
  model, jax_params, port = seeded_pair(tiny_config(**VARIANTS[name]))
  cfg, n, b = port.config, 4, 2
  images = _images(cfg, b, seed=2)
  labels, conditioning = _labels_and_conditioning(b, seed=3)
  u = np.array([0.375, 0.81], np.float32)
  grid = np.mod(u[:, None] + np.arange(n) / n, 1.0).astype(np.float32)
  frozen_latent_randomness(monkeypatch)
  out = jax.jit(lambda p: model.apply(
      {'params': p}, jnp.asarray(np.repeat(images, n, 0)),
      jnp.asarray(np.repeat(labels, n, 0)),
      jnp.asarray(np.repeat(conditioning, n, 0)), 0,
      jnp.asarray(grid.reshape(-1)), rngs={'sample': jax.random.PRNGKey(0)},
      deterministic=True, method=model.elbo))(jax_params)
  nats = out.loss_recon + out.loss_klz + out.loss_diff
  want = np.asarray(nats).reshape(b, n).mean(1) / (cfg.n_pixels * np.log(2))
  calls = _Calls(port.encoder_model)
  eps = to_torch(shaped_normal((b * n, *cfg.image_shape)))
  with torch.no_grad():
    got = vlb.dense_chunk_bpd(
        port, torch.from_numpy(images), n, labels=torch.from_numpy(labels),
        conditioning=torch.from_numpy(conditioning), u=to_torch(u),
        eps0=eps, eps=eps, latent_noise=latent_noise_for(cfg, b * n))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
  assert calls.sizes == {None: [], 'rows': [b * n],
                         'images': [b]}[encoder_rows]
  # The estimator over dict batches, as the data iterators yield them.
  batch = {'images': images, 'labels': labels, 'conditioning': conditioning}
  bpd = vlb.eval_bpd_dense(port, [batch], n_timesteps=n,
                           generator=torch.Generator().manual_seed(0))
  sparse = vlb.eval_bpd_sparse(port, [batch],
                               generator=torch.Generator().manual_seed(0))
  assert np.isfinite(bpd) and np.isfinite(sparse)


@pytest.mark.parametrize('name', ['ldm', 'no_z_conditioning', 'gumbel',
                                  'learnable_nnet'])
def test_conditional_sample_matches_jax(monkeypatch, name):
  """One ancestral step given an embedding, and with `sample` the
  canonical embedding of the latent type; the batch's conditioning feeds
  the UNet without `z_conditioning`."""
  model, jax_params, port = seeded_pair(tiny_config(**VARIANTS[name]))
  cfg = port.config
  frozen_latent_randomness(monkeypatch)
  rs = np.random.RandomState(6)
  z_t = rs.standard_normal((B, *cfg.image_shape)).astype(np.float32)
  emb = latents.logits_to_embeddings(
      to_torch(rs.standard_normal((B, cfg.latent_size)).astype(np.float32)),
      cfg.latent_k).numpy()
  _, conditioning = _labels_and_conditioning(seed=7)
  want = jax.jit(lambda p: (
      model.apply({'params': p}, 3, 10, jnp.asarray(z_t), jnp.asarray(emb),
                  jnp.asarray(conditioning), jax.random.PRNGKey(0),
                  method=model.conditional_sample),
      model.apply({'params': p}, 3, 10, jnp.asarray(z_t),
                  jnp.asarray(conditioning), jax.random.PRNGKey(0),
                  method=model.sample)))(jax_params)
  eps = to_torch(shaped_normal(z_t.shape))
  with torch.no_grad():
    got = (port.conditional_sample(3, 10, to_torch(z_t), to_torch(emb),
                                   conditioning=to_torch(conditioning),
                                   eps=eps),
           port.sample(3, 10, to_torch(z_t),
                       conditioning=to_torch(conditioning), eps=eps))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('name', ['gumbel', 'gaussian'])
def test_generate_x_sample_softmax_matches_jax(monkeypatch, name):
  """The decode from the latent type's canonical embedding, with
  `sample_softmax` a categorical draw (JAX's Gumbel-max, frozen) that
  differs from the argmax."""
  cfg = tiny_config(sample_softmax=True, **VARIANTS[name])
  model, jax_params, port = seeded_pair(cfg)
  frozen_latent_randomness(monkeypatch)
  z_0 = np.random.RandomState(8).standard_normal(
      (B, *cfg.image_shape)).astype(np.float32) * 0.02
  want = jax.jit(lambda p: model.apply(
      {'params': p}, jnp.asarray(z_0),
      rngs={'sample': jax.random.PRNGKey(0)},
      method=model.generate_x))(jax_params)
  gumbel = shaped_gumbel((B, *cfg.image_shape, cfg.vocab_size))
  with torch.no_grad():
    got = port.generate_x(to_torch(z_0), gumbel=to_torch(gumbel))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  port.config = dataclasses.replace(cfg, sample_softmax=False)
  with torch.no_grad():
    assert (port.generate_x(to_torch(z_0)) != got).any()


def test_apply_gamma_matches_jax(monkeypatch):
  """gamma at t on the Gumbel latent of images at a step (the annealed
  temperature), and on a zero embedding."""
  model, jax_params, port = seeded_pair(tiny_config(latent_type='gumbel'))
  cfg = port.config
  frozen_latent_randomness(monkeypatch)
  images = _images(cfg, seed=9)
  t = np.array([0.2, 0.5, 0.7, 0.9], np.float32)
  want = jax.jit(lambda p: (
      model.apply({'params': p}, jnp.asarray(t), jnp.asarray(images), 50_000,
                  True, rngs={'sample': jax.random.PRNGKey(0)},
                  method=model.apply_gamma),
      model.apply({'params': p}, jnp.asarray(t), method=model.apply_gamma)))(
          jax_params)
  with torch.no_grad():
    got = (port.apply_gamma(to_torch(t), images, step=50_000,
                            latent_noise=latent_noise_for(cfg, B)),
           port.apply_gamma(to_torch(t)))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)
