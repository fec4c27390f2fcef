"""The port's MuLAN-epsilon (`vdm_type='mulan_epsilon'`, the `imagenet32`
config) and `velocity_from_epsilon` against the JAX package's MuLAN,
float32 on the CPU: the config, the ELBO's terms in continuous and discrete
time, the sampler step, the decode, the SDE, the score and its JVP, the
probability-flow drift, the parameter tree and the registry, and a forward
at ImageNet32's width (256 channels, so attention at head_dim 256) at
depth 1.

Parameters are the port's seeded `init_params` of a tiny MuLAN (8x8 images,
32 channels, 2 layers), handed to flax through `params.to_flax`; the JAX
side draws its noise through the patched, shape-seeded `jax.random` of
`parity_helpers.frozen_randomness`, and the port is handed the same arrays.
"""

import dataclasses

from flax.traverse_util import flatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.configs import imagenet32 as jax_imagenet32
from mulan_tpu.models import build_model as build_jax_model
from mulan_tpu.models import model_config_from_dict
from mulan_tpu_torch import configs, params
from mulan_tpu_torch.models import MuLAN, build_model, latents, make_model
from mulan_tpu_torch.models import mulan as mulan_lib
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.ops import ode
from parity_helpers import frozen_randomness
from torch_port_helpers import (jax_config, seeded_pair, shaped_gamma,
                                shaped_normal, to_torch)
from test_torch_train import _assert_section

B = 2
TINY = tiny_config()
# The ELBO's summed terms, as in tests/test_torch_vdm.py: float32 on both
# sides, per-pixel differences of 1e-5 summed over an example, in nats.
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3
# One network evaluation (the score, its JVP, the drift), as a fraction of
# the output's largest magnitude, as in tests/test_torch_ode.py.
NET_RTOL = 1e-5
IMAGES = np.random.RandomState(0).randint(
    0, 256, size=(B, *TINY.image_shape)).astype(np.uint8)
# (vdm_type, model overrides): the epsilon model and a velocity model whose
# network predicts epsilon.
VARIANTS = {'epsilon': ('mulan_epsilon', {}),
            'velocity_from_epsilon': ('mulan_velocity',
                                      {'velocity_from_epsilon': True})}


@pytest.fixture(scope='module')
def pair():
  """(flax MuLAN-epsilon, its params, the port's MuLAN-epsilon), TINY."""
  return seeded_pair(TINY, vdm_type='mulan_epsilon')


def _variant(pair, name, **more):
  """(flax model, params, port model) of a VARIANTS entry on the pair's
  parameters (both parameterizations have one parameter tree)."""
  _, params_jax, port = pair
  vdm_type, overrides = VARIANTS[name]
  cfg = dataclasses.replace(TINY, **overrides, **more)
  model = make_model(vdm_type, cfg)
  model.load_state_dict(port.state_dict())
  return build_jax_model(vdm_type, jax_config(cfg)), params_jax, model.eval()


# -- the config and the registry ------------------------------------------------


def test_imagenet32_config_matches_jax():
  """Field by field: the top level, the model, training and the optimizer;
  the JAX file's path resolves to it, and its model builds (on meta) as a
  MuLAN-epsilon with 256 channels."""
  port, want = configs.imagenet32(), jax_imagenet32.get_config()
  assert port.vdm_type == want.vdm_type == 'mulan_epsilon'
  assert port.ckpt_restore_dir == want.ckpt_restore_dir
  assert port.lr_gamma_network_scale == want.lr_gamma_network_scale == 1.0
  for section in ('data', 'training', 'optimizer'):
    _assert_section(getattr(port, section), want[section])
  model = model_config_from_dict(dict(want.model))
  for field in dataclasses.fields(port.model):
    jax_name = 'use_pallas' if field.name == 'use_kernels' else field.name
    assert getattr(port.model, field.name) == getattr(model, jax_name), (
        field.name)
  assert port.data.dataset == 'imagenet32'
  assert port.training.batch_size_train == port.training.batch_size_eval == 512
  assert configs.get_config('mulan_tpu/configs/imagenet32.py') == port
  assert configs.get_config('imagenet32') == port
  with torch.device('meta'):
    model = make_model('mulan_epsilon', port.model)
  assert isinstance(model, MuLAN) and model.parameterization == 'epsilon'
  assert model.score_model.mid_attn_1.q.weight.shape == (256, 256)


def test_registry_and_devices(monkeypatch):
  """Both MuLAN entries build a MuLAN of their parameterization;
  `build_model` asks for the card unless the CPU is asked for."""
  assert make_model('mulan_velocity', TINY).parameterization == 'velocity'
  model = build_model('mulan_epsilon', TINY, device='cpu')
  assert isinstance(model, MuLAN) and model.parameterization == 'epsilon'
  fresh = params.init_params(TINY, torch.Generator().manual_seed(0),
                             vdm_type='mulan_epsilon')
  assert all(torch.equal(model.state_dict()[k], v) for k, v in fresh.items())
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    build_model('mulan_epsilon', TINY)
  with pytest.raises(ValueError, match='unknown parameterization'):
    MuLAN(TINY, parameterization='x0')


def test_parameter_tree_matches_flax_epsilon_init():
  """The epsilon model's tree is the velocity model's: `init_params` and
  `to_flax` give the names and shapes of `jax.eval_shape` of the flax init
  with parameterization='epsilon', and `from_flax` gives them back."""
  model = build_jax_model('mulan_epsilon', jax_config(TINY))
  shapes = jax.eval_shape(lambda: model.init(
      {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)},
      jnp.zeros((B, *TINY.image_shape), jnp.uint8), jnp.zeros((B,)),
      jnp.zeros((B,)), -1.0))['params']
  want = {k: tuple(v.shape) for k, v in flatten_dict(shapes,
                                                     sep='/').items()}
  state = params.init_params(TINY, torch.Generator().manual_seed(0),
                             vdm_type='mulan_epsilon')
  flat = params.to_flax(state)
  assert {k: v.shape for k, v in flat.items()} == want
  assert state.keys() == params.init_params(
      TINY, torch.Generator().manual_seed(0)).keys()
  back = params.from_flax(flat)
  assert all(torch.equal(back[k], v) for k, v in state.items())


# -- the ELBO -------------------------------------------------------------------


def _frozen_forward(monkeypatch):
  """Patches the port's draws in `forward` to the frozen jax.random's: the
  antithetic grid from u = 0.375, the normals and the Gamma variates."""
  monkeypatch.setattr(mulan_lib, 'sample_times', lambda n, **kw: to_torch(
      jnp.mod(0.375 + jnp.arange(0.0, 1.0, step=1.0 / n), 1.0)))
  monkeypatch.setattr(MuLAN, '_randn', lambda self, shape, generator: (
      to_torch(shaped_normal(tuple(shape)))))
  monkeypatch.setattr(latents, 'gamma_variates', lambda k, shape, **kw: (
      to_torch(shaped_gamma(1.0 / k, (latents.N_GAMMA_TERMS, *shape)))))


@pytest.mark.parametrize('name,sm_n_timesteps', [
    ('epsilon', 0), ('epsilon', 10), ('velocity_from_epsilon', 0)])
def test_elbo_terms_match_jax(pair, monkeypatch, name, sm_n_timesteps):
  """`forward` (antithetic times, rounded up to the grid when
  sm_n_timesteps > 0) and the ELBO's terms against JAX's `__call__`: the
  epsilon loss weighted by dgamma/dt or by T expm1(g_t - g_s), and the
  velocity loss of a network read as epsilon."""
  model, params_jax, port = _variant(pair, name,
                                     sm_n_timesteps=sm_n_timesteps)
  frozen_randomness(monkeypatch)
  want = jax.jit(lambda p, x: model.apply(
      {'params': p}, x, jnp.zeros((B,), jnp.int32), jnp.zeros((B,)), 0,
      rngs={'sample': jax.random.PRNGKey(0)}))(params_jax,
                                               jnp.asarray(IMAGES))
  _frozen_forward(monkeypatch)
  with torch.no_grad():
    got = port(torch.from_numpy(IMAGES))
  for field in ('loss_recon', 'loss_klz', 'loss_diff', 'var_0', 'var_1'):
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)),
                               rtol=ELBO_RTOL, atol=ELBO_ATOL, err_msg=field)
  if sm_n_timesteps:  # the grid and the weight differ from continuous time
    continuous = make_model('mulan_epsilon', TINY)
    continuous.load_state_dict(port.state_dict())
    with torch.no_grad():
      other = continuous(torch.from_numpy(IMAGES))
    assert not torch.allclose(other.loss_diff, got.loss_diff)
    assert torch.equal(other.loss_recon, got.loss_recon)


def test_velocity_in_discrete_time_raises(pair):
  """JAX asserts that the velocity loss is continuous-time; the port raises
  the same error, at the same call."""
  model, params_jax, port = _variant(pair, 'velocity_from_epsilon',
                                     sm_n_timesteps=10)
  with pytest.raises(AssertionError, match='continuous-time'):
    jax.jit(lambda p, x: model.apply(  # raises while tracing
        {'params': p}, x, jnp.zeros((B,), jnp.int32), jnp.zeros((B,)), 0,
        rngs={'sample': jax.random.PRNGKey(0)}))(params_jax,
                                                 jnp.asarray(IMAGES))
  with pytest.raises(AssertionError, match='continuous-time'):
    port(torch.from_numpy(IMAGES), generator=torch.Generator())


# -- sampling, the SDE, the score and the drift ------------------------------------


def _assert_net_close(got, want, what):
  want = np.asarray(want, np.float64)
  err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
  assert err <= NET_RTOL, (what, err)


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_sampler_step_decode_sde_score_and_drift_match_jax(pair, monkeypatch,
                                                           name):
  """One conditional ancestral step (its noise JAX's frozen draw), one
  unconditional step, `generate_x`, `sde`, `score_fn`, `score_jvp` and
  `reverse_ode` (high_precision both ways, at t where the guard takes over
  and mid-way) against JAX's."""
  model, params_jax, port = _variant(pair, name)
  cfg = port.config
  rs = np.random.RandomState(4)
  shape = (B, *cfg.image_shape)
  z = rs.standard_normal(shape).astype(np.float32)
  emb = latents.logits_to_embeddings(torch.from_numpy(
      rs.standard_normal((B, cfg.latent_size)).astype(np.float32)),
                                     cfg.latent_k).numpy()
  g = 3 * rs.standard_normal(shape).astype(np.float32)
  v = rs.standard_normal(shape).astype(np.float32)
  frozen_randomness(monkeypatch)

  def apply(method, *args):
    return jax.jit(lambda p, *a: model.apply(
        {'params': p}, *a, method=getattr(model, method)))(params_jax, *args)
  eps = to_torch(shaped_normal(shape))
  want = jax.jit(lambda p, z, e: model.apply(
      {'params': p}, 3, 10, z, e, jnp.zeros((B,), jnp.uint8),
      jax.random.PRNGKey(0), method=model.conditional_sample))(
          params_jax, z, emb)
  with torch.no_grad():
    got = port.conditional_sample(3, 10, torch.from_numpy(z),
                                  torch.from_numpy(emb), eps=eps)
  _assert_net_close(got, want, 'conditional_sample')
  rng = jax.random.PRNGKey(4)
  want = jax.jit(lambda p, z: model.apply(
      {'params': p}, 3, 10, z, jnp.zeros((B,), jnp.uint8), rng,
      method=model.sample))(params_jax, z)
  with torch.no_grad():
    got = port.sample(3, 10, torch.from_numpy(z), eps=eps)
  _assert_net_close(got, want, 'sample')

  z0 = 0.01 * z
  x_want = np.asarray(jax.jit(lambda p, z: model.apply(
      {'params': p}, z, rngs={'sample': jax.random.PRNGKey(0)},
      method=model.generate_x))(params_jax, z0))
  with torch.no_grad():
    x_got = port.generate_x(torch.from_numpy(z0)).numpy()
  np.testing.assert_array_equal(x_got, x_want)

  with torch.no_grad():
    got = port.sde(torch.from_numpy(z), torch.from_numpy(emb), ode.f32(0.3))
  for part, a, b in zip(('drift', 'diffusion'), got,
                        apply('sde', z, emb, jnp.float32(0.3))):
    _assert_net_close(a, b, part)
  with torch.no_grad():
    got = port.score_fn(*(torch.from_numpy(a) for a in (z, g, emb)))
  _assert_net_close(got, apply('score_fn', z, g, emb), 'score_fn')
  got = port.score_jvp(*(torch.from_numpy(a) for a in (z, g, emb, v)))
  want = apply('score_jvp', z, g, emb, v)
  _assert_net_close(got[0], want[0], 'score_jvp score')
  _assert_net_close(got[1], want[1], 'score_jvp tangent')

  for t in (1e-3, 0.5):
    for high_precision in (False, True):
      want = jax.jit(lambda p, x, e, tt: model.apply(
          {'params': p}, x, e, tt, high_precision,
          method=model.reverse_ode))(params_jax, z, emb, jnp.float32(t))
      with torch.no_grad():
        got = port.reverse_ode(torch.from_numpy(z), torch.from_numpy(emb),
                               ode.f32(t), high_precision)
      _assert_net_close(got, want, ('reverse_ode', t, high_precision))


def test_velocity_from_epsilon_is_the_epsilon_model(pair):
  """A velocity model whose network predicts epsilon is, in exact
  arithmetic, the epsilon model: its loss (1 - sigma^2)(v - v-hat)^2 is
  (eps - eps-hat)^2, and its sampler step, score and drift convert back to
  the epsilon forms. On one set of weights and inputs the two agree to
  float32 rounding; the velocity model reads the same network otherwise."""
  rs = np.random.RandomState(5)
  z = torch.from_numpy(rs.standard_normal((B, *TINY.image_shape))
                       .astype(np.float32))
  eps = torch.from_numpy(rs.standard_normal(z.shape).astype(np.float32))
  emb = latents.deterministic_embedding(B, TINY.latent_size, TINY.latent_k)
  t = torch.tensor([0.3, 0.8])
  topk = latents.gamma_variates(TINY.latent_k, (B, TINY.latent_size),
                                generator=torch.Generator().manual_seed(0),
                                device='cpu')
  outs = {}
  for name, (vdm_type, overrides) in (('velocity', ('mulan_velocity', {})),
                                      *VARIANTS.items()):
    m = make_model(vdm_type, dataclasses.replace(TINY, **overrides))
    m.load_state_dict(pair[2].state_dict())
    with torch.no_grad():
      outs[name] = (
          m.elbo(torch.from_numpy(IMAGES), t, eps0=eps, eps=eps,
                 latent_noise=topk).loss_diff,
          m.sample(3, 10, z, eps=eps),
          m.reverse_ode(z, emb, ode.f32(0.5)),
          m.score_fn(z, torch.full_like(z, -2.0), emb))
  for got, want, other in zip(outs['velocity_from_epsilon'],
                              outs['epsilon'], outs['velocity']):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert not torch.allclose(other, want, rtol=1e-2)


# -- ImageNet32's width -------------------------------------------------------------


def test_imagenet32_width_shallow_elbo_matches_jax(monkeypatch):
  """imagenet32's model at depth 1 (256 channels, 32x32x3, float32) with
  the kernel flags on, both sides on their CPU paths: the attention blocks
  see T = 1024 tokens of head_dim 256 (the port's plain attention, JAX's
  einsum path). ELBO terms at 1e-4 relative."""
  cfg = dataclasses.replace(configs.imagenet32().model, sm_n_layer=1,
                            forward_n_layer=1, compute_dtype='float32')
  model, params_jax, port = seeded_pair(cfg, vdm_type='mulan_epsilon')
  assert port.score_model.mid_attn_1.q.weight.shape == (256, 256)
  images = np.random.RandomState(9).randint(
      0, 256, size=(B, *cfg.image_shape)).astype(np.uint8)
  t = np.array([0.2, 0.7], np.float32)
  frozen_randomness(monkeypatch)
  want = jax.jit(lambda p, x, tt: model.apply(
      {'params': p}, x, jnp.zeros((B,), jnp.int32), jnp.zeros((B,)), 0, tt,
      rngs={'sample': jax.random.PRNGKey(0)}, deterministic=True,
      method=model.elbo))(params_jax, jnp.asarray(images), jnp.asarray(t))
  eps = to_torch(shaped_normal(images.shape))
  noise = to_torch(shaped_gamma(1.0 / cfg.latent_k, (
      latents.N_GAMMA_TERMS, B, cfg.latent_size)))
  with torch.no_grad():
    got = port.elbo(torch.from_numpy(images), to_torch(t), eps0=eps, eps=eps,
                    latent_noise=noise)
  for field in ('loss_recon', 'loss_klz', 'loss_diff', 'var_0', 'var_1'):
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)),
                               rtol=ELBO_RTOL, atol=ELBO_ATOL, err_msg=field)
