"""The port's baseline VDM against the JAX package's, float32 on the CPU: the
scalar schedules and `DenseMonotone`, the ELBO's three terms (continuous
and discrete time, both parameterizations), the sampler step, the decode,
the SDE and the probability-flow drift, train-mode gradients with dropout
masks injected, the decoder backward's plain version (K5's) against JAX's
`_bwd` and against the full-vocab closed form in float64, the parameter
tree, the registry and the `vdm_cifar10` config.

Parameters are the port's seeded `init_params` of a tiny VDM (8x8 images,
16 channels, 2 layers, the `learnable_nnet` schedule), handed to flax
through `params.to_flax`; the JAX side draws its noise through the patched,
shape-seeded `jax.random` of `parity_helpers.frozen_randomness`, and the
port is handed the same arrays.
"""

import dataclasses

from flax.traverse_util import flatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.configs import vdm_cifar10 as jax_vdm_cifar10
from mulan_tpu.models import layers as jax_layers
from mulan_tpu.models import model_config_from_dict
from mulan_tpu.models import schedules as jax_schedules
from mulan_tpu.models import vdm as jax_vdm
from mulan_tpu.ops import decoder_logprob as jax_decoder
from mulan_tpu_torch import configs, params
from mulan_tpu_torch.models import (MuLAN, VDM, build_model, layers,
                                    make_model, schedules)
from mulan_tpu_torch.models import vdm as vdm_lib
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.ops import decoder_logprob as dec_ops
from mulan_tpu_torch.train.loop import Experiment
from parity_helpers import frozen_randomness
from torch_port_helpers import (jax_config, seeded_pair, shaped_normal,
                                to_torch)
from test_torch_train import (GRAD_ATOL_FRAC, GRAD_RTOL, _inject_masks,
                              _jax_loss_and_grads)

B = 2
TINY = tiny_config(sm_n_embd=16, gamma_type='learnable_nnet',
                   z_conditioning=False)
# The ELBO's summed terms, as in tests/test_torch_evals.py: float32 on both
# sides, per-pixel differences of 1e-5 summed over an example, in nats.
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-3
# A schedule: the same float32 operations on gamma in [-13.3, 5].
SCHEDULE_TOL = 1e-6
IMAGES = np.random.RandomState(0).randint(
    0, 256, size=(B, *TINY.image_shape)).astype(np.uint8)


@pytest.fixture(scope='module')
def pair():
  """(flax VDM, its params, the port's VDM with them), TINY."""
  return seeded_pair(TINY, vdm_type='vdm')


# -- the schedules -----------------------------------------------------------


def _random_schedule_state(key, rs):
  """Parameters of a port schedule with every term of its gamma and
  dgamma/dt away from 0 (the MLP's correction included)."""
  if key == 'learnable_scalar':
    return {'w': torch.tensor([-17.1]), 'b': torch.tensor([-12.9])}
  if key != 'learnable_nnet':
    return {}
  n = 1024
  return {'l1.kernel': torch.tensor([[18.3]]),
          'l1.bias': torch.tensor([-13.3]),
          'l2.kernel': to_torch(3 * rs.standard_normal((1, n))).float(),
          'l2.bias': to_torch(rs.standard_normal(n)).float(),
          'l3.kernel': to_torch(40 * rs.standard_normal((n, 1))).float()}


@pytest.mark.parametrize('key', sorted(jax_schedules.SCALAR_SCHEDULES))
def test_scalar_schedule_matches_jax(key):
  """gamma and dgamma/dt of every SCALAR_SCHEDULES entry at 9 times in
  [0, 1]; JAX takes dgamma/dt by `jax.jvp` for the MLP and the BDM shapes,
  the port by its closed forms."""
  rs = np.random.RandomState(1)
  port = schedules.SCALAR_SCHEDULES[key](TINY)
  state = _random_schedule_state(key, rs)
  port.load_state_dict(state)
  jax_params = {}
  for name, value in state.items():
    node = jax_params
    *mods, leaf = name.split('.')
    for m in mods:
      node = node.setdefault(m, {})
    node[leaf] = jnp.asarray(value.numpy())
  sched = jax_schedules.SCALAR_SCHEDULES[key](jax_config(TINY))
  t = np.linspace(0.0, 1.0, 9).astype(np.float32)
  want = sched.apply({'params': jax_params}, jnp.asarray(t),
                     method=sched.gamma_and_dgamma)
  got = port.gamma_and_dgamma(torch.from_numpy(t))
  for name, g, w in zip(('gamma', 'dgamma'), got, want):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                               rtol=SCHEDULE_TOL, atol=SCHEDULE_TOL,
                               err_msg=name)
  np.testing.assert_allclose(port(torch.from_numpy(t)).detach().numpy(),
                             np.asarray(want[0]), rtol=SCHEDULE_TOL,
                             atol=SCHEDULE_TOL)


def test_nnet_dgamma_is_differentiable_in_the_parameters():
  """The closed-form dgamma/dt carries gradients to the MLP's kernels (the
  loss weight 0.5 dgamma/dt mse trains them): d/dw of dgamma at t against
  JAX's jvp differentiated by `jax.grad`."""
  rs = np.random.RandomState(2)
  port = schedules.NoiseScheduleNNet(TINY)
  state = _random_schedule_state('learnable_nnet', rs)
  port.load_state_dict(state)
  t = torch.tensor([0.3, 0.7])
  port.gamma_and_dgamma(t)[1].sum().backward()
  sched = jax_schedules.NoiseScheduleNNet(jax_config(TINY))
  jax_params = {m: {leaf: jnp.asarray(v.numpy()) for (mm, leaf), v in
                    ((n.split('.'), v) for n, v in state.items()) if mm == m}
                for m in ('l1', 'l2', 'l3')}
  grads = jax.grad(lambda p: jnp.sum(sched.apply(
      {'params': p}, jnp.asarray(t.numpy()),
      method=sched.gamma_and_dgamma)[1]))(jax_params)
  assert port.l1.bias.grad is None and not np.asarray(
      grads['l1']['bias']).any()  # dgamma/dt does not depend on it
  for name, p in port.named_parameters():
    m, leaf = name.split('.')
    want = np.asarray(grads[m][leaf])
    if p.grad is not None:
      np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                 atol=1e-6 * np.abs(want).max(),
                                 err_msg=name)


def test_dense_monotone_matches_flax():
  rs = np.random.RandomState(3)
  x = rs.standard_normal((4, 3)).astype(np.float32)
  flax_layer = jax_layers.DenseMonotone(5)
  p = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
  p = {'kernel': jnp.asarray(rs.standard_normal((3, 5)), jnp.float32),
       'bias': jnp.asarray(rs.standard_normal(5), jnp.float32)}
  port = layers.DenseMonotone(3, 5)
  port.load_state_dict({k: to_torch(v) for k, v in p.items()})
  want = flax_layer.apply({'params': p}, jnp.asarray(x))
  np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                             np.asarray(want), rtol=1e-6, atol=1e-6)
  assert not layers.DenseMonotone(3, 1, use_bias=False).bias


# -- the model -----------------------------------------------------------------


def _jax_model(cfg):
  return jax_vdm.VDM(jax_config(cfg))


@pytest.mark.parametrize('reparam_type', ['true', 'input'])
@pytest.mark.parametrize('sm_n_timesteps', [0, 10])
def test_elbo_terms_match_jax(pair, monkeypatch, sm_n_timesteps,
                              reparam_type):
  """`forward` (antithetic times, rounded up to the grid when
  sm_n_timesteps > 0) and the three ELBO terms against JAX's `__call__`,
  mirroring tests/test_vdm_reparam.py: the discrete weighting differs under
  'input', the MSE stays against eps."""
  _, params_jax, port = pair
  cfg = dataclasses.replace(TINY, sm_n_timesteps=sm_n_timesteps,
                            reparam_type=reparam_type)
  model = _jax_model(cfg)
  frozen_randomness(monkeypatch)
  want = jax.jit(lambda p, x: model.apply(
      {'params': p}, x, jnp.zeros((B,), jnp.int32), jnp.zeros((B,)), 0,
      rngs={'sample': jax.random.PRNGKey(0)}))(params_jax,
                                               jnp.asarray(IMAGES))
  ported = VDM(cfg)
  ported.load_state_dict(port.state_dict())
  # The frozen uniform draw (0.375) in JAX's antithetic grid, and its
  # normal draws (eps_0 and eps have one shape, so one array).
  monkeypatch.setattr(vdm_lib, 'sample_times', lambda n, **kw: to_torch(
      jnp.mod(0.375 + jnp.arange(0.0, 1.0, step=1.0 / n), 1.0)))
  monkeypatch.setattr(VDM, '_randn', lambda self, shape, generator: to_torch(
      shaped_normal(tuple(shape))))
  with torch.no_grad():
    got = ported(torch.from_numpy(IMAGES))
  for name in ('loss_recon', 'loss_klz', 'loss_diff', 'var_0', 'var_1'):
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)),
                               rtol=ELBO_RTOL, atol=ELBO_ATOL, err_msg=name)
  if sm_n_timesteps:  # the weighting depends on the parameterization
    other = 'true' if reparam_type == 'input' else 'input'
    ported.config = dataclasses.replace(cfg, reparam_type=other)
    with torch.no_grad():
      flipped = ported(torch.from_numpy(IMAGES))
    assert not torch.allclose(flipped.loss_diff, got.loss_diff)
    assert torch.equal(flipped.loss_recon, got.loss_recon)


@pytest.mark.parametrize('reparam_type', ['true', 'input'])
def test_sampler_step_decode_sde_and_ode_drift_match_jax(pair, monkeypatch,
                                                          reparam_type):
  """One ancestral step (its noise JAX's frozen draw), `generate_x`, `sde`
  and `reverse_ode` against JAX's; under 'input' the output is converted
  to eps-hat in the step and in the drift."""
  _, params_jax, port = pair
  cfg = dataclasses.replace(TINY, reparam_type=reparam_type)
  model = _jax_model(cfg)
  ported = VDM(cfg)
  ported.load_state_dict(port.state_dict())
  shape = (B, *cfg.image_shape)
  z = np.random.RandomState(4).standard_normal(shape).astype(np.float32)
  frozen_randomness(monkeypatch)

  def apply(method, *args):
    return model.apply({'params': params_jax}, *args,
                       method=getattr(model, method))
  want = apply('sample', 3, 10, jnp.asarray(z), jnp.zeros((B,)),
               jax.random.PRNGKey(0))
  with torch.no_grad():
    got = ported.sample(3, 10, torch.from_numpy(z),
                        eps=to_torch(shaped_normal(shape)))
    also = ported.conditional_sample(3, 10, torch.from_numpy(z),
                                     torch.ones((B, 7)),
                                     eps=to_torch(shaped_normal(shape)))
  scale = np.abs(np.asarray(want)).max()
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                             atol=1e-5 * scale)
  assert torch.equal(also, got)

  z0 = 0.01 * z
  x_want = np.asarray(apply('generate_x', jnp.asarray(z0)))
  with torch.no_grad():
    x_got = ported.generate_x(torch.from_numpy(z0)).numpy()
  assert (x_got == x_want).mean() >= 0.99 and np.abs(
      x_got - x_want).max() <= 1
  # With `sample_softmax` a categorical draw (Gumbel-max). At a bin's
  # centre, g_0 near gamma_min leaves e^-18 of the mass to each neighbour.
  drawn = VDM(dataclasses.replace(cfg, sample_softmax=True))
  drawn.load_state_dict(port.state_dict())
  values = np.random.RandomState(5).randint(0, 256, size=shape)
  with torch.no_grad():
    x_drawn = drawn.generate_x(
        torch.from_numpy(2 * (values + 0.5) / 256 - 1).float(),
        generator=torch.Generator().manual_seed(0)).numpy()
  np.testing.assert_array_equal(x_drawn, values)

  t = np.array([0.2, 0.9], np.float32)
  for got_part, want_part in zip(
      ported.sde(torch.from_numpy(z), torch.from_numpy(t)),
      apply('sde', jnp.asarray(z), jnp.asarray(t))):
    np.testing.assert_allclose(got_part.detach().numpy(),
                               np.asarray(want_part), rtol=1e-5, atol=1e-6)
  emb = np.zeros((B, 1), np.float32)
  want = apply('reverse_ode', jnp.asarray(z), jnp.asarray(emb),
               jnp.float32(0.4))
  with torch.no_grad():
    got = ported.reverse_ode(torch.from_numpy(z), torch.from_numpy(emb),
                             torch.tensor(0.4))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                             atol=1e-5 * np.abs(np.asarray(want)).max())
  np.testing.assert_allclose(
      ported.apply_gamma(0.5).detach().numpy(),
      np.asarray(apply('apply_gamma', 0.5)), rtol=1e-6)
  assert not ported.apply_encoder(torch.from_numpy(IMAGES)).any()


def test_sample_times_options():
  """Antithetic: one uniform u, t_i = (u + i / n) mod 1; i.i.d.: n
  uniforms. Both in [0, 1), from the generator."""
  gen = torch.Generator().manual_seed(5)
  t = vdm_lib.sample_times(8, generator=gen)
  steps = torch.remainder(t - t[0], 1.0)
  torch.testing.assert_close(steps, torch.arange(8) / 8.0, atol=1e-6,
                             rtol=0)
  iid = vdm_lib.sample_times(1000, antithetic=False,
                             generator=torch.Generator().manual_seed(5))
  assert iid.shape == (1000,) and 0 <= iid.min() and iid.max() < 1
  assert abs(iid.mean().item() - 0.5) < 0.05
  assert len(torch.unique(iid)) == 1000


# -- train-mode gradients ------------------------------------------------------


def _vdm_train_config():
  """vdm_cifar10 cut to TINY, with the kernel flag on (so JAX takes
  `hw_dropout` and its Pallas decoder, whose `_bwd` sums dg0 back to the
  scalar g0, and the port its mask functions and K5's plain version)."""
  cfg = configs.vdm_cifar10()
  return configs.replace(
      cfg, model=dataclasses.asdict(dataclasses.replace(TINY,
                                                        use_kernels=True)),
      data={'dataset': 'synthetic', 'synthetic_examples': 64},
      training={'num_steps_lr_warmup': 1, 'batch_size_train': 4,
                'batch_size_eval': 4},
      optimizer=dataclasses.replace(cfg.optimizer, learning_rate=2e-3))


@pytest.mark.parametrize('pdrop', [0.1, 0.0])
def test_train_loss_and_gradients_match_jax(pair, monkeypatch, pdrop):
  """The train-mode bpd and every gradient, the `gamma/*` leaves included,
  with the same dropout masks on both sides."""
  _, params_jax, port = pair
  cfg = configs.replace(_vdm_train_config(), model={'sm_pdrop': pdrop})
  model = jax_vdm.VDM(jax_config(cfg.model))
  ex = Experiment(cfg, device='cpu', state=port.state_dict())
  frozen_randomness(monkeypatch)
  _inject_masks(monkeypatch)
  n = 4
  rs = np.random.RandomState(6)
  batch = {'images': rs.randint(0, 256, size=(n, *TINY.image_shape))
                     .astype(np.uint8),
           'labels': np.zeros((n,), np.int32),
           'conditioning': np.zeros((n,), np.uint8)}
  # Jitted: eagerly, the interpreted Pallas kernels dispatch op by op.
  (bpd_want, scalars_want), grads_want = jax.jit(
      lambda p, b: _jax_loss_and_grads(model, p, cfg, b, 0))(params_jax,
                                                            batch)
  eps = to_torch(shaped_normal((n, *TINY.image_shape)))
  noise = dict(t=to_torch(jnp.mod(0.375 + jnp.arange(0.0, 1.0,
                                                     step=1.0 / n), 1.0)),
               eps0=eps, eps=eps, dropout_seed=0)
  bpd, scalars = ex.loss_fn(ex.model, batch, train=True, noise=noise)
  bpd.backward()
  for key, value in scalars_want.items():
    np.testing.assert_allclose(scalars[key].item(), float(value), rtol=1e-4,
                               atol=1e-6, err_msg=key)
  want = params.from_flax({k: np.asarray(v) for k, v in
                           flatten_dict(grads_want, sep='/').items()})
  got = {k: p.grad for k, p in ex.model.named_parameters()}
  assert got.keys() == want.keys()
  assert {k for k in got if k.startswith('gamma.')} == {
      'gamma.l1.kernel', 'gamma.l1.bias', 'gamma.l2.kernel', 'gamma.l2.bias',
      'gamma.l3.kernel'}
  scale = max(w.abs().max().item() for w in want.values())
  for name, w in want.items():
    np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRAC * scale, err_msg=name)
  assert all(got[k].abs().max() > 0 for k in got if k.startswith('gamma.'))


# -- the decoder backward (K5's plain version) ---------------------------------


@pytest.mark.parametrize('g0_value', [-13.3, 0.0, 5.0])
@pytest.mark.parametrize('g0_kind', ['scalar', 'per_example'])
def test_decoder_bwd_plain_matches_jax_bwd(g0_kind, g0_value):
  """`decoder_logprob_bwd_plain` with a broadcast g0 against JAX's `_bwd`
  (its Pallas `_bwd_kernel` in interpret mode, then the sum back to g0's
  shape, `mulan_tpu/ops/decoder_logprob.py:141-168`)."""
  rs = np.random.RandomState(7)
  shape = (3, 4, 4, 3)
  x = rs.randint(0, 256, size=shape).astype(np.float32)
  g0 = np.full(() if g0_kind == 'scalar' else (3, 1, 1, 1), g0_value,
               np.float32)
  if g0_kind == 'per_example':
    g0 = g0 + rs.uniform(-0.5, 0.5, size=g0.shape).astype(np.float32)
  z = (2 * (x + 0.5) / 256 - 1 + np.exp(0.5 * g0)
       * rs.standard_normal(shape)).astype(np.float32)
  ct = rs.standard_normal(3).astype(np.float32)
  _, want_dz, want_dg = jax_decoder._bwd(
      256, (jnp.asarray(x), jnp.asarray(z), jnp.asarray(g0)),
      jnp.asarray(ct))
  dz, dg = dec_ops.decoder_logprob_bwd_plain(
      torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(g0),
      torch.from_numpy(ct))
  assert dg.shape == g0.shape
  # Relative to the largest entry, as in tests/test_torch_grads.py; and
  # dz = ct e^-g0 (e_x - E_p[e]) cancels: both sides round E_p[e] (|e| < 1)
  # in float32, each its own way where a neighbouring bin's weight enters,
  # and e^-g0 (6e5 at gamma_min) multiplies that: a few ulps of 1 times
  # |ct| e^-g0 besides.
  cancel = 4 * 2.0 ** -24 * np.abs(ct).max() * np.exp(-g0).max()
  for got, want, extra in ((dz, want_dz, cancel), (dg, want_dg, 0.0)):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max() + extra)


def _full_vocab_bwd(x, z, g0, ct, vocab=256):
  """dz and the per-pixel dg0 from the softmax over every bin, float64."""
  e = 2 * (torch.arange(vocab, dtype=torch.float64) + 0.5) / vocab - 1
  inv_var = torch.exp(-torch.broadcast_to(g0, z.shape))
  l = -0.5 * torch.square(z[..., None] - e) * inv_var[..., None]
  p = torch.softmax(l, dim=-1)
  e_x = 2 * (torch.round(x) + 0.5) / vocab - 1
  ct = ct.reshape(-1, 1, 1, 1)
  dz = ct * inv_var * (e_x - (p * e).sum(-1))
  dg = ct * 0.5 * inv_var * (torch.square(z - e_x) - (
      p * torch.square(z[..., None] - e)).sum(-1))
  return dz, dg


@pytest.mark.parametrize('g0_value', [-13.3, 0.0, 5.0])
def test_windowed_bwd_matches_the_full_vocab_in_float64(g0_value):
  """In float64 the window drops only terms below e^-104 of the largest:
  per pixel, per example and one g0, dz and dg0 as the full-vocab softmax
  gives them, to float64 rounding (e^-g0 up to 6e5 times |e| ~ 1e-16)."""
  rs = np.random.RandomState(8)
  shape = (3, 4, 4, 3)
  x = torch.from_numpy(rs.randint(0, 256, size=shape).astype(np.float64))
  ct = torch.from_numpy(rs.standard_normal(3))
  for g_shape in (shape, (3, 1, 1, 1), ()):
    g0 = g0_value + torch.from_numpy(rs.uniform(-0.3, 0.3, size=g_shape))
    z = 2 * (x + 0.5) / 256 - 1 + torch.exp(0.5 * g0) * torch.from_numpy(
        rs.standard_normal(shape))
    dz, dg = dec_ops.decoder_logprob_bwd_plain(x, z, g0, ct)
    want_dz, want_dg = _full_vocab_bwd(x, z, g0, ct)
    want_dg = want_dg.sum_to_size(g_shape)
    assert dz.dtype == dg.dtype == torch.float64 and dg.shape == g_shape
    torch.testing.assert_close(dz, want_dz, rtol=1e-9,
                               atol=1e-12 * want_dz.abs().max().item())
    torch.testing.assert_close(dg, want_dg, rtol=1e-9,
                               atol=1e-12 * want_dg.abs().max().item())
    first, last = dec_ops.logsumexp_window(z, torch.broadcast_to(
        g0, z.shape))
    if g0_value < -10:  # the VDM's g0: a handful of bins a pixel
      assert (last - first + 1).max() <= 9
    if g0_value > 4:
      assert (last - first + 1).min() == 256


def test_backward_computes_only_what_autograd_asks_for():
  """With g0 alone requiring grad (or z alone), the other gradient is not
  formed; a broadcast g0's gradient keeps g0's shape."""
  rs = np.random.RandomState(9)
  shape = (2, 4, 4, 3)
  x = torch.from_numpy(rs.randint(0, 256, size=shape).astype(np.float32))
  z = 2 * (x + 0.5) / 256 - 1 + 0.01 * torch.from_numpy(
      rs.standard_normal(shape).astype(np.float32))
  calls = []
  real = dec_ops.decoder_logprob_bwd

  def spy(*args, **kwargs):
    calls.append((kwargs['need_dz'], kwargs['need_dg0']))
    return real(*args, **kwargs)
  dec_ops_bwd = dec_ops.decoder_logprob_bwd
  try:
    dec_ops.decoder_logprob_bwd = spy
    g0 = torch.tensor(-6.0, requires_grad=True)
    (dg,) = torch.autograd.grad(dec_ops.decoder_logprob(x, z, g0).sum(), g0)
    zz = z.clone().requires_grad_()
    (dz,) = torch.autograd.grad(
        dec_ops.decoder_logprob(x, zz, torch.tensor(-6.0)).sum(), zz)
  finally:
    dec_ops.decoder_logprob_bwd = dec_ops_bwd
  assert calls == [(False, True), (True, False)]
  assert dg.shape == () and dz.shape == shape
  assert dec_ops.g0_mode(torch.zeros(()), z) == dec_ops.ONE
  assert dec_ops.g0_mode(torch.zeros((2, 1, 1, 1)), z) == dec_ops.PER_EXAMPLE
  assert dec_ops.g0_mode(torch.zeros(shape), z) == dec_ops.PER_PIXEL
  assert dec_ops.g0_mode(torch.zeros((1, 1, 1, 3)), z) == dec_ops.PER_PIXEL


# -- parameters, the registry and the config ----------------------------------


def test_vdm_parameter_tree_round_trips_through_flax():
  """`init_params`, `from_flax` and `to_flax` on the VDM tree: JAX's names
  and shapes (from `jax.eval_shape` of its init), the DenseMonotone kernels
  in flax's (in, out) layout, `dense0` at n_embd + 1, JAX's schedule
  initializers."""
  model = _jax_model(TINY)
  shapes = jax.eval_shape(lambda: model.init(
      {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)},
      jnp.zeros((B, *TINY.image_shape), jnp.uint8), jnp.zeros((B,)),
      jnp.zeros((B,)), -1.0))['params']
  want = {k: tuple(v.shape) for k, v in flatten_dict(shapes,
                                                     sep='/').items()}
  state = params.init_params(TINY, torch.Generator().manual_seed(0),
                             vdm_type='vdm')
  flat = params.to_flax(state)
  assert {k: v.shape for k, v in flat.items()} == want
  assert flat['score_model/dense0/kernel'].shape == (TINY.sm_n_embd + 1,
                                                     4 * TINY.sm_n_embd)
  back = params.from_flax(flat)
  assert back.keys() == state.keys()
  assert all(torch.equal(back[k], v) for k, v in state.items())
  np.testing.assert_array_equal(flat['gamma/l2/kernel'],
                                state['gamma.l2.kernel'].numpy())
  span = TINY.gamma_max - TINY.gamma_min
  assert state['gamma.l1.kernel'].item() == pytest.approx(span)
  assert state['gamma.l1.bias'].item() == pytest.approx(TINY.gamma_min)
  assert not state['gamma.l2.bias'].any()
  # flax's normal(): stddev 1e-2 (jax.nn.initializers.normal's default).
  assert 0.008 < state['gamma.l2.kernel'].std().item() < 0.012
  perturbed = params.init_params(TINY, torch.Generator().manual_seed(0),
                                 perturb_zero_init=0.02, vdm_type='vdm')
  assert all(v.any() for v in perturbed.values())
  scalar = params.init_params(dataclasses.replace(
      TINY, gamma_type='learnable_scalar'), torch.Generator(),
                              vdm_type='vdm')
  assert scalar['gamma.w'].item() == pytest.approx(span)
  assert scalar['gamma.b'].item() == pytest.approx(TINY.gamma_min)


def test_build_model_registry():
  cfg = TINY
  assert isinstance(build_model('vdm', cfg, device='cpu'), VDM)
  assert isinstance(build_model('mulan_velocity', tiny_config(),
                                device='cpu'), MuLAN)
  epsilon = make_model('mulan_epsilon', tiny_config())
  assert isinstance(epsilon, MuLAN) and epsilon.parameterization == 'epsilon'
  with pytest.raises(ValueError, match='unknown vdm_type'):
    make_model('ldm', cfg)
  with pytest.raises(ValueError, match='scalar gamma_type'):
    VDM(tiny_config())  # poly_fixedend is MuLAN's


def test_vdm_cifar10_config_matches_jax():
  port, want = configs.vdm_cifar10(), jax_vdm_cifar10.get_config()
  assert port.vdm_type == want.vdm_type == 'vdm'
  model = model_config_from_dict(dict(want.model))
  for field in dataclasses.fields(port.model):
    jax_name = 'use_pallas' if field.name == 'use_kernels' else field.name
    assert getattr(port.model, field.name) == getattr(model, jax_name), (
        field.name)
  assert configs.get_config('mulan_tpu/configs/vdm_cifar10.py') == port
  with torch.device('meta'):
    vdm = make_model('vdm', port.model)
  assert vdm.score_model.dense0.weight.shape == (512, 129)
  assert sum(p.numel() for p in vdm.gamma.parameters()) == 3 * 1024 + 2
