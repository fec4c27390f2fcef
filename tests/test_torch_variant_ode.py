"""The probability-flow ODE of the port's MuLAN variants against the JAX
package's, float32 on the CPU: the likelihood through a 2-step RK4 (JAX's
jitted; its DoPri5 is never compiled over the network), the ODE sampler on
the per-pixel-gamma UNet with DoPri5 swapped for RK4 on both sides, and the
variants whose ODE path JAX refuses, refused by both.

Models are the port's seeded `init_params` of the tiny config without
Fourier features, the zero-initialized leaves perturbed, handed to flax
through `params.to_flax`.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.evals import nll_ode as jax_nll
from mulan_tpu.ops.ode import odeint_rk4 as jax_rk4
from mulan_tpu_torch.evals import nll_ode
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.ops import ode
from torch_port_helpers import (VARIANTS, frozen_latent_randomness,
                                seeded_pair, shaped_normal)

# log p, log q and the latent KL after a solve, as tests/test_torch_nll_ode.py.
LIKELIHOOD_RTOL = 1e-4


def _images(cfg, n, seed=0):
  rs = np.random.RandomState(seed)
  return rs.randint(0, 256, size=(n, *cfg.image_shape)).astype(np.uint8)


ODE_SHAPE = (2, 8, 8, 3)
U_TN = np.clip(np.random.RandomState(1).standard_normal(ODE_SHAPE), -3,
               3).astype(np.float32)
PROBE = (2 * np.random.RandomState(3).randint(0, 2, size=ODE_SHAPE)
         - 1).astype(np.float32)


def _ode_pair(name):
  """The variant without Fourier features (see tests/test_torch_nll_ode.py:
  with them a 2-step RK4 amplifies float32 rounding past the tolerance)."""
  return seeded_pair(tiny_config(with_fourier_features=False,
                                 **VARIANTS[name]))


@pytest.mark.parametrize('name', ['ldm_learnable_nnet', 'gumbel', 'cnn'])
def test_ode_likelihood_matches_jax(monkeypatch, name):
  """log p, log q(eps) and the latent KL of a 2-step RK4 solve, the
  dequantization draw and the probe injected on both sides."""
  model, jax_params, port = _ode_pair(name)
  images = _images(port.config, 2, seed=0)
  monkeypatch.setattr(jax.random, 'truncated_normal',
                      lambda *a, **k: jnp.asarray(U_TN))
  monkeypatch.setattr(jax_nll, '_hutchinson_noise',
                      lambda *a: jnp.asarray(PROBE))
  want = jax.jit(jax_nll.make_ode_likelihood_fn(
      model, model.config, odeint=functools.partial(jax_rk4, num_steps=2)))(
          jax_params, jax.random.PRNGKey(0), images)
  with torch.inference_mode():
    got = nll_ode.make_ode_likelihood_fn(
        port, odeint=functools.partial(ode.odeint_rk4, num_steps=2))(
            images, u=U_TN, probe=PROBE)
  for label, a, b in zip(('log_p', 'log_q_eps', 'aux'), got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                               rtol=LIKELIHOOD_RTOL, err_msg=label)


def test_ode_sampler_matches_jax_on_the_ldm_unet(monkeypatch):
  """`make_ode_sample_fn` with DoPri5 swapped for a 2-step RK4 on both
  sides (as tests/test_torch_nll_ode.py), on the per-pixel-gamma UNet."""
  model, jax_params, port = _ode_pair('ldm_learnable_nnet')
  cfg = port.config
  frozen_latent_randomness(monkeypatch)
  monkeypatch.setattr(jax_nll, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      jax_rk4(f, y, t0, t1, num_steps=2)))
  monkeypatch.setattr(nll_ode, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      ode.odeint_rk4(f, y, t0, t1, num_steps=2)))
  n = 3
  want, _ = jax.jit(lambda p: jax_nll.make_ode_sample_fn(
      model, model.config)(p, jax.random.PRNGKey(0), n))(jax_params)
  got, nfe = nll_ode.make_ode_sample_fn(port)(
      n, logits=shaped_normal((n, cfg.latent_size)),
      prior=shaped_normal((n, *cfg.image_shape)))
  assert nfe == 8
  np.testing.assert_allclose(got.numpy(), np.asarray(want),
                             rtol=LIKELIHOOD_RTOL, atol=LIKELIHOOD_RTOL)


# {variant: (what JAX's likelihood raises, what the port's message names)}.
ODE_REFUSALS = {
    'gaussian': (TypeError, 'nll_ode.py:150'),
    'no_z_conditioning': (flax.errors.ScopeParamShapeError, 'unet.py:76'),
    'reparam_none': (flax.errors.ScopeParamNotFoundError, 'nll_ode.py:148'),
}


@pytest.mark.parametrize('name', list(ODE_REFUSALS))
def test_ode_likelihood_refused_where_jax_raises(name):
  """JAX's likelihood feeds the encoder's output to `gumbel_kl` and the
  hard top-k, and the embedding to the score UNet whatever
  `z_conditioning` says (`mulan_tpu/evals/nll_ode.py:143-156`): it raises
  for the Gaussian latent, without an encoder and without
  `z_conditioning`; the port raises too, naming JAX's line. Without
  `z_conditioning` the ODE sampler is refused on both sides as well."""
  error, line = ODE_REFUSALS[name]
  model, jax_params, port = _ode_pair(name)
  images = _images(port.config, 2, seed=0)
  with pytest.raises(error):
    jax.jit(jax_nll.make_ode_likelihood_fn(
        model, model.config, odeint=functools.partial(jax_rk4, num_steps=1)))(
            jax_params, jax.random.PRNGKey(0), images)
  with pytest.raises(ValueError, match=line):
    with torch.inference_mode():
      nll_ode.make_ode_likelihood_fn(
          port, odeint=functools.partial(ode.odeint_rk4, num_steps=1))(
              images, u=U_TN, probe=PROBE)
  if name == 'no_z_conditioning':
    with pytest.raises(error):
      jax.jit(lambda p: jax_nll.make_ode_sample_fn(
          model, model.config, max_steps=2)(p, jax.random.PRNGKey(0), 2))(
              jax_params)
    with pytest.raises(ValueError, match=line):
      nll_ode.make_ode_sample_fn(port, max_steps=2)(2)
