"""The port's MuLAN variants against the JAX package's, float32 on the CPU:
the latents (top-k with Gumbel noise, the annealed Gumbel argmax, the
Gaussian), the Gaussian and CNN encoders, the `learnable_nnet` and `linear`
schedules (dgamma/dt against `jax.jvp`, and its gradient with respect to
the parameters), the ELBO terms of every variant, and the time sampling.

Each model is the port's seeded `init_params` of the tiny config with its
zero-initialized leaves perturbed (so that `cond_proj`, the attention
output and the last convolutions reach the output), handed to flax
through `params.to_flax`. The JAX side draws its noise through the frozen
`jax.random` of `torch_port_helpers.frozen_latent_randomness`; the port is
handed the same arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import latents as jax_latents
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models import mulan as port_mulan
from mulan_tpu_torch.models.config import tiny_config
from torch_port_helpers import (VARIANTS, frozen_latent_randomness,
                                latent_noise_for, nchw, seeded_pair,
                                shaped_gumbel, shaped_normal, to_torch)

# Modules: float32 on both sides, matmuls summed in another order.
RTOL, ATOL = 1e-5, 1e-5
# The encoder trunk's output: convolutions compounded over its blocks.
TRUNK_RTOL = 1e-4
# Summed ELBO terms: per-pixel differences summed over every pixel of an
# example, in nats (as tests/test_torch_model.py).
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3
B = 4
# A step far enough into training that the Gumbel temperature is annealed:
# max(0.5, exp(-1e-5 step)) = 0.61.
STEP = 50_000


def _rand(shape, seed, lo=None, hi=None):
  rs = np.random.RandomState(seed)
  if lo is None:
    return rs.standard_normal(shape).astype(np.float32)
  return rs.uniform(lo, hi, size=shape).astype(np.float32)


def _images(cfg, seed=0):
  rs = np.random.RandomState(seed)
  return rs.randint(0, 256, size=(B, *cfg.image_shape)).astype(np.uint8)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=''):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol, err_msg=msg)


_PAIRS = {}


def _pair(name):
  """(flax model, flax params, port) of VARIANTS[name], built once."""
  if name not in _PAIRS:
    _PAIRS[name] = seeded_pair(tiny_config(**VARIANTS[name]))
  return _PAIRS[name]


# -- latents ------------------------------------------------------------------


@pytest.mark.parametrize('step', [0, STEP, 10 ** 7])
def test_gumbel_embedding_matches_jax(monkeypatch, step):
  """The straight-through Gumbel argmax at tau = 1, 0.61 and 0.5, forward
  and the softmax's gradient."""
  frozen_latent_randomness(monkeypatch)
  shape = (B, 10)
  logits, ct = _rand(shape, 1), _rand(shape, 2)
  want, vjp = jax.vjp(lambda l: jax_latents.gumbel_embedding(
      jax.random.PRNGKey(0), l, step), jnp.asarray(logits))
  x = to_torch(logits).requires_grad_()
  got = latents.gumbel_embedding(x, step, to_torch(shaped_gumbel(shape)))
  got.backward(to_torch(ct))
  _close(got.detach(), want)
  _close(x.grad, vjp(jnp.asarray(ct))[0])
  assert (got.detach().sum(-1) == 1).all()


def test_gaussian_embedding_matches_jax(monkeypatch):
  frozen_latent_randomness(monkeypatch)
  shape = (B, 10)
  mu, var = _rand(shape, 3), _rand(shape, 4, 0.1, 2.0)
  want = jax_latents.gaussian_embedding(jax.random.PRNGKey(0),
                                        jnp.asarray(mu), jnp.asarray(var))
  got = latents.gaussian_embedding(to_torch(mu), to_torch(var),
                                   to_torch(shaped_normal(shape)))
  for g, w in zip(got, want):
    _close(g, w)


def test_topk_with_gumbel_noise_matches_jax(monkeypatch):
  frozen_latent_randomness(monkeypatch)
  shape, k = (B, 10), 3
  logits = _rand(shape, 5)
  want = jax_latents.topk_embedding(jax.random.PRNGKey(0),
                                    jnp.asarray(logits), k,
                                    noise_type='gumbel')
  got = latents.topk_embedding(to_torch(logits), k,
                               to_torch(shaped_gumbel(shape)))
  for g, w in zip(got, want):
    _close(g, w)


@pytest.mark.parametrize('latent_type', ['topk', 'gumbel', 'gaussian'])
def test_deterministic_embedding_matches_jax(latent_type):
  want = jax_latents.deterministic_embedding(3, 10, 4, latent_type)
  got = latents.deterministic_embedding(3, 10, 4, latent_type)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_latent_variates_shapes_and_laws():
  """The draws `elbo` takes when none is passed: their shapes, and their
  means (Gamma(1/k): 1/k; Gumbel: the Euler-Mascheroni constant; normal:
  0) over 40 000 values."""
  gen = torch.Generator().manual_seed(0)
  n = 4000
  for overrides, shape, mean in (
      ({}, (latents.N_GAMMA_TERMS, n, 10), 1 / 3),
      ({'topk_noise_type': 'gumbel'}, (n, 10), 0.5772),
      ({'latent_type': 'gumbel'}, (n, 10), 0.5772),
      ({'latent_type': 'gaussian'}, (n, 10), 0.0)):
    draw = latents.latent_variates(tiny_config(**overrides), n,
                                   generator=gen, device='cpu')
    assert draw.shape == shape, overrides
    assert abs(draw.mean().item() - mean) < 0.03, overrides


# -- encoders and schedules ---------------------------------------------------


@pytest.mark.parametrize('name', ['gaussian', 'cnn'])
def test_encoder_matches_jax(name):
  """The Gaussian's (mu, softplus sigma) heads on the trunk, the CNN's
  logits (its NHWC flatten pinned)."""
  model, params, port = _pair(name)
  f = _rand((B, *port.config.image_shape), 6, -1.0, 1.0)
  want = model.apply({'params': params}, jnp.asarray(f),
                     method=lambda m, x: m.encoder_model(x,
                                                         deterministic=True))
  with torch.no_grad():
    got = port.encoder_model(nchw(f))
  rtol = RTOL if name == 'cnn' else TRUNK_RTOL
  for g, w in zip(jax.tree_util.tree_leaves(got),
                  jax.tree_util.tree_leaves(want)):
    _close(g, w, rtol=rtol)


@pytest.mark.parametrize('name', ['learnable_nnet', 'linear'])
def test_schedule_matches_jax(name):
  """gamma, (gamma, dgamma/dt) against JAX's `jax.jvp`, and the ELBO's
  three gammas, at t in [0, 1]."""
  model, params, port = _pair(name)
  cfg = port.config
  emb = _rand((B, cfg.latent_size), 7)
  t = np.array([0.0, 0.25, 0.6, 1.0], np.float32)
  want = model.apply(
      {'params': params}, jnp.asarray(emb), jnp.asarray(t),
      method=lambda m, e, tt: (m.gamma(e, tt), m.gamma.gamma_and_dgamma(e, tt),
                               m.gamma.elbo_gammas(e, tt)))
  with torch.no_grad():
    got = (port.gamma(to_torch(emb), to_torch(t)),
           port.gamma.gamma_and_dgamma(to_torch(emb), to_torch(t)),
           port.gamma.elbo_gammas(to_torch(emb), to_torch(t)))
  leaves = jax.tree_util.tree_leaves([got[0], *got[1], *got[2]])
  for w, g in zip(jax.tree_util.tree_leaves(want), leaves, strict=True):
    assert g.shape == (B, cfg.n_pixels)
    _close(g, w, atol=ATOL * np.abs(np.asarray(w)).max())


def test_nnet_dgamma_gradient_matches_jax():
  """The closed-form dgamma/dt carries the parameters' gradient: that of
  sum(c dgamma/dt + c' gamma) against JAX's through `jax.jvp`."""
  model, params, port = _pair('learnable_nnet')
  cfg = port.config
  emb = _rand((B, cfg.latent_size), 8)
  t = np.array([0.1, 0.4, 0.7, 0.95], np.float32)
  c, c2 = _rand((B, cfg.n_pixels), 9), _rand((B, cfg.n_pixels), 10)

  def loss(p):
    g, dg = model.apply({'params': p}, jnp.asarray(emb), jnp.asarray(t),
                        method=lambda m, e, tt: m.gamma.gamma_and_dgamma(
                            e, tt))
    return jnp.sum(c * dg + c2 * g)
  want = jax.grad(loss)(params)['gamma']
  g, dg = port.gamma.gamma_and_dgamma(to_torch(emb), to_torch(t))
  torch.sum(to_torch(c) * dg + to_torch(c2) * g).backward()
  for layer in ('l1', 'l2', 'l_int', 'l3'):
    for leaf, w in want[layer].items():
      got = getattr(getattr(port.gamma, layer), leaf).grad
      w = np.asarray(w)
      _close(got, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
             msg=f'{layer}.{leaf}')


# -- the ELBO of every variant ------------------------------------------------


def _labels_and_conditioning(seed=11):
  rs = np.random.RandomState(seed)
  return (rs.randint(0, 10, size=B).astype(np.int32),
          rs.randint(0, 2, size=B).astype(np.uint8))


def _elbo_pair(model, params, port, images, t, monkeypatch, step=STEP):
  cfg = port.config
  frozen_latent_randomness(monkeypatch)
  labels, conditioning = _labels_and_conditioning()
  want = jax.jit(lambda p: model.apply(
      {'params': p}, jnp.asarray(images), jnp.asarray(labels),
      jnp.asarray(conditioning), step, jnp.asarray(t),
      rngs={'sample': jax.random.PRNGKey(0)}, deterministic=True,
      method=model.elbo))(params)
  # eps_0 and eps are drawn with the same shape, so the frozen contract
  # makes them the same tensor.
  eps = to_torch(shaped_normal(images.shape))
  with torch.no_grad():
    got = port.elbo(torch.from_numpy(images), to_torch(t),
                    labels=torch.from_numpy(labels),
                    conditioning=torch.from_numpy(conditioning), step=step,
                    eps0=eps, eps=eps,
                    latent_noise=latent_noise_for(cfg, images.shape[0]))
  for name in ('loss_recon', 'loss_klz', 'loss_diff', 'var_0', 'var_1'):
    _close(getattr(got, name), getattr(want, name), rtol=ELBO_RTOL,
           atol=ELBO_ATOL, msg=name)
  return got


@pytest.mark.parametrize('name', list(VARIANTS))
def test_variant_elbo_matches_jax(name, monkeypatch):
  model, params, port = _pair(name)
  t = np.array([0.05, 0.3, 0.55, 0.8], np.float32)
  got = _elbo_pair(model, params, port, _images(port.config), t,
                   monkeypatch)
  if port.config.gamma_type != 'poly_fixedend':  # the ends are not pinned
    assert got.var_0 != torch.sigmoid(torch.tensor(port.config.gamma_min))


def test_discrete_time_epsilon_nnet_elbo_matches_jax(monkeypatch):
  """MuLAN-epsilon with T = 10 on the learned schedule: the loss weight
  T expm1(g_t - g_s) takes the schedule at t - 1/T."""
  cfg = tiny_config(gamma_type='learnable_nnet', sm_n_timesteps=10)
  model, params, port = seeded_pair(cfg, vdm_type='mulan_epsilon')
  t = np.array([0.1, 0.3, 0.6, 1.0], np.float32)
  _elbo_pair(model, params, port, _images(cfg, 1), t, monkeypatch)


@pytest.mark.parametrize('antithetic', [True, False])
def test_forward_time_sampling_matches_jax(monkeypatch, antithetic):
  """`forward` draws t antithetically or i.i.d. as the config says
  (`sample_times`); with uniform draws frozen at 0.375 on both sides, the
  two give different times, and each matches JAX's `__call__`."""
  base = dataclasses.replace(_pair('gumbel')[2].config,
                             antithetic_time_sampling=antithetic)
  model, params, port = seeded_pair(base)
  images = _images(base, 2)
  labels, conditioning = _labels_and_conditioning(12)
  frozen_latent_randomness(monkeypatch)
  want = jax.jit(lambda p: model.apply(
      {'params': p}, jnp.asarray(images), jnp.asarray(labels),
      jnp.asarray(conditioning), STEP,
      rngs={'sample': jax.random.PRNGKey(0)}, deterministic=True))(params)
  drawn = []

  def rand(shape, generator=None, device=None):
    drawn.append(tuple(shape))
    return torch.full(shape, 0.375)
  monkeypatch.setattr(torch, 'rand', rand)
  monkeypatch.setattr(port_mulan.MuLAN, '_randn',
                      lambda self, shape, gen: to_torch(shaped_normal(shape)))
  monkeypatch.setattr(latents, 'latent_variates',
                      lambda cfg, b, **unused: latent_noise_for(cfg, b))
  with torch.no_grad():
    got = port(torch.from_numpy(images), labels=torch.from_numpy(labels),
               conditioning=torch.from_numpy(conditioning), step=STEP)
  assert drawn == ([()] if antithetic else [(B,)])
  for name in ('loss_recon', 'loss_klz', 'loss_diff'):
    _close(getattr(got, name), getattr(want, name), rtol=ELBO_RTOL,
           atol=ELBO_ATOL, msg=name)
