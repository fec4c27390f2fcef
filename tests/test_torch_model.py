"""The port's MuLAN-velocity against the JAX package's, float32 on the CPU.

One flax init of the tiny config (8x8 images, 32 channels, 2 layers) is
transplanted into the port; the JAX side draws its noise through the
patched, shape-seeded `jax.random` of `parity_helpers.frozen_randomness`,
and the port is handed the same arrays. A last test runs the flagship's
width (128 channels, 32x32x3, so T=1024 and D=128 attention) at depth 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import latents as jax_latents
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.config import flagship_config, tiny_config
from parity_helpers import frozen_randomness
from torch_port_helpers import (mulan_pair, nchw, nhwc, shaped_gamma,
                                shaped_normal, to_torch)

# Network outputs: float32 on both sides, convolutions summed in another
# order (1e-5 relative per layer, compounded over the UNet's depth).
RTOL, ATOL = 1e-4, 1e-5
# Summed ELBO terms: per-pixel differences of that size summed over every
# pixel of an example, in nats.
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3

B = 4


@pytest.fixture(scope='module')
def pair():
  return mulan_pair(tiny_config(), batch=B)


def _rand(shape, seed, lo=None, hi=None):
  rs = np.random.RandomState(seed)
  if lo is None:
    return rs.standard_normal(shape).astype(np.float32)
  return rs.uniform(lo, hi, size=shape).astype(np.float32)


def _images(cfg, seed=0):
  rs = np.random.RandomState(seed)
  return rs.randint(0, 256, size=(B, *cfg.image_shape)).astype(np.uint8)


def test_unet_matches_jax(pair):
  model, params, port = pair
  cfg = port.config
  z = _rand((B, *cfg.image_shape), 0)
  g_t = _rand((B,), 1, cfg.gamma_min, cfg.gamma_max)
  cond = _rand((B, cfg.latent_size), 2)
  want = model.apply({'params': params}, jnp.asarray(z), jnp.asarray(g_t),
                     jnp.asarray(cond),
                     method=lambda m, *a: m.score_model(*a,
                                                        deterministic=True))
  with torch.no_grad():
    got = port.score_model(nchw(z), to_torch(g_t), to_torch(cond))
  np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


def test_encoder_matches_jax(pair):
  """Also pins the NHWC flatten of the 1-channel head."""
  model, params, port = pair
  f = _rand((B, *port.config.image_shape), 3, -1.0, 1.0)
  want = model.apply({'params': params}, jnp.asarray(f),
                     method=lambda m, x: m.encoder_model(x,
                                                         deterministic=True))
  with torch.no_grad():
    got = port.encoder_model(nchw(f))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


def test_gamma_schedule_matches_jax(pair):
  model, params, port = pair
  cfg = port.config
  emb = _rand((B, cfg.latent_size), 4)
  t = np.array([0.0, 0.25, 0.6, 1.0], np.float32)
  want = model.apply(
      {'params': params}, jnp.asarray(emb), jnp.asarray(t),
      method=lambda m, e, tt: (m.gamma(e, tt), m.gamma.gamma_and_dgamma(e, tt),
                               m.gamma.elbo_gammas(e, tt)))
  with torch.no_grad():
    got = (port.gamma(to_torch(emb), to_torch(t)),
           port.gamma.gamma_and_dgamma(to_torch(emb), to_torch(t)),
           port.gamma.elbo_gammas(to_torch(emb), to_torch(t)))
  for w, g in zip(jax.tree_util.tree_leaves(want),
                  jax.tree_util.tree_leaves([got[0], *got[1], *got[2]])):
    assert g.shape == (B, cfg.n_pixels)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                               atol=ATOL)


def test_topk_embedding_matches_jax(monkeypatch):
  """Gamma noise from the same variates; mean-centred, L2-normalized soft
  part; hard mask >= the k-th value."""
  frozen_randomness(monkeypatch)
  k, shape = 3, (B, 10)
  logits = _rand(shape, 5)
  want_emb, want_kl = jax_latents.topk_embedding(jax.random.PRNGKey(0),
                                                 jnp.asarray(logits), k)
  variates = to_torch(shaped_gamma(1.0 / k, (latents.N_GAMMA_TERMS, *shape)))
  emb, kl = latents.topk_embedding(to_torch(logits), k,
                                   latents.gamma_noise(k, variates))
  np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=RTOL,
                             atol=ATOL)
  np.testing.assert_allclose(kl.numpy(), np.asarray(want_kl), rtol=RTOL,
                             atol=ATOL)


def _elbo_pair(model, params, port, images, t, monkeypatch):
  cfg = port.config
  frozen_randomness(monkeypatch)
  b = images.shape[0]
  want = model.apply({'params': params}, jnp.asarray(images),
                     jnp.zeros((b,), jnp.int32), jnp.zeros((b,)), 0,
                     jnp.asarray(t), rngs={'sample': jax.random.PRNGKey(0)},
                     deterministic=True, method=model.elbo)
  # eps_0 and eps are drawn with the same shape, so the frozen contract
  # makes them the same tensor.
  eps = to_torch(shaped_normal(images.shape))
  noise = to_torch(shaped_gamma(1.0 / cfg.latent_k,
                                (latents.N_GAMMA_TERMS, b, cfg.latent_size)))
  with torch.no_grad():
    got = port.elbo(torch.from_numpy(images), to_torch(t), eps0=eps, eps=eps,
                    latent_noise=noise)
  for name in ('loss_recon', 'loss_klz', 'loss_diff', 'var_0', 'var_1'):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)),
                               rtol=ELBO_RTOL, atol=ELBO_ATOL, err_msg=name)


def test_elbo_matches_jax(pair, monkeypatch):
  model, params, port = pair
  t = np.array([0.05, 0.3, 0.55, 0.8], np.float32)
  _elbo_pair(model, params, port, _images(port.config), t, monkeypatch)


def test_conditional_sample_matches_jax(pair, monkeypatch):
  model, params, port = pair
  cfg = port.config
  frozen_randomness(monkeypatch)
  z_t = _rand((B, *cfg.image_shape), 6)
  emb = np.asarray(latents.logits_to_embeddings(
      to_torch(_rand((B, cfg.latent_size), 7)), cfg.latent_k))
  want = model.apply({'params': params}, 3, 10, jnp.asarray(z_t),
                     jnp.asarray(emb), jnp.zeros((B,), jnp.uint8),
                     jax.random.PRNGKey(0),
                     method=model.conditional_sample)
  with torch.no_grad():
    got = port.conditional_sample(3, 10, to_torch(z_t), to_torch(emb),
                                  eps=to_torch(shaped_normal(z_t.shape)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


def test_sample_matches_jax(pair):
  """One unconditional step (the canonical embedding) with JAX's own noise
  for step i, `normal(fold_in(rng, i))`, handed to the port as `eps`."""
  model, params, port = pair
  z_t = _rand((B, *port.config.image_shape), 9)
  rng = jax.random.PRNGKey(4)
  want = model.apply({'params': params}, 3, 10, jnp.asarray(z_t),
                     jnp.zeros((B,), jnp.uint8), rng, method=model.sample)
  eps = jax.random.normal(jax.random.fold_in(rng, 3), z_t.shape)
  with torch.no_grad():
    got = port.sample(3, 10, to_torch(z_t), eps=to_torch(eps))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


def test_generate_x_matches_jax(pair):
  model, params, port = pair
  z_0 = _rand((B, *port.config.image_shape), 8)
  want = model.apply({'params': params}, jnp.asarray(z_0),
                     rngs={'sample': jax.random.PRNGKey(0)},
                     method=model.generate_x)
  with torch.no_grad():
    got = port.generate_x(to_torch(z_0))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_width_shallow_elbo_matches_jax(monkeypatch):
  """Flagship width, depth 1, kernel flags on (both sides take their CPU
  paths): the attention blocks see T=1024 tokens of D=128."""
  cfg = flagship_config(sm_n_layer=1, forward_n_layer=1,
                        compute_dtype='float32')
  model, params, port = mulan_pair(cfg, batch=2)
  images = np.random.RandomState(9).randint(
      0, 256, size=(2, *cfg.image_shape)).astype(np.uint8)
  _elbo_pair(model, params, port, images, np.array([0.2, 0.7], np.float32),
             monkeypatch)
