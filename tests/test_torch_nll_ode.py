"""The port's exact NLL through the probability-flow ODE and its ODE sampler
against the JAX package's, float32 on the CPU: one RHS evaluation (drift
and Hutchinson divergence), an RK4 likelihood with both dequantizations,
the divergence against the Jacobian's trace, DoPri5 against scipy on the
model's RHS, the bpd offsets and importance-sample groups, the estimator's
aggregation and failure rules, the probe's redraw policy, the sampler, and
the command lines end to end.

Parameters are the port's seeded `init_params` of tiny_synthetic's model
(8x8 images, 16 channels, 2 layers, no Fourier features), handed to flax.
The JAX likelihood is jitted with a 2-step RK4 (its DoPri5 is never
compiled over the network); its dequantization draw and Hutchinson probe
are patched to the arrays the port is handed.
"""

import functools
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate
import torch

from mulan_tpu.evals import nll_ode as jax_nll
from mulan_tpu.ops.ode import odeint_rk4 as jax_rk4
from mulan_tpu.parallel import mesh as mesh_lib
from mulan_tpu_torch import configs, eval_bpd, main
from mulan_tpu_torch.evals import nll_ode
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.ops import ode
from mulan_tpu_torch.train import checkpoint as ckpt_lib
from mulan_tpu_torch.train.loop import Experiment
from parity_helpers import frozen_randomness
from torch_port_helpers import jax_config, seeded_pair, shaped_normal

# An RHS evaluation, as a fraction of each output's largest magnitude:
# float32 on both sides, convolutions summed in another order.
RHS_RTOL = 1e-5
# log p, log q and the latent KL after a solve: the RHS's differences
# integrated over 8 evaluations, on values of 1e2-1e3 nats.
LIKELIHOOD_RTOL = 1e-4
B = 2
# Without the UNet's Fourier features (sin and cos of x 2^k 2 pi, k = 6, 7):
# with them the seeded drift's Jacobian is large enough that a 2-step RK4
# amplifies float32 rounding from one stage to the next far past
# LIKELIHOOD_RTOL, though each RHS evaluation agrees at RHS_RTOL. The
# Fourier path is held against JAX in tests/test_torch_ode.py.
CFG = configs.replace(configs.tiny_synthetic(),
                      model={'with_fourier_features': False})
SHAPE = (B, *CFG.model.image_shape)


def _rs(seed):
  return np.random.RandomState(seed)


IMAGES = _rs(0).randint(0, 256, size=SHAPE).astype(np.uint8)
U_TN = np.clip(_rs(1).standard_normal(SHAPE), -3, 3).astype(np.float32)
U_UNIFORM = _rs(2).uniform(size=SHAPE).astype(np.float32)
PROBE = (2 * _rs(3).randint(0, 2, size=SHAPE) - 1).astype(np.float32)
RK4 = functools.partial(ode.odeint_rk4, num_steps=2)


@pytest.fixture(scope='module')
def pair():
  """(flax model, flax params, the port's MuLAN with them)."""
  return seeded_pair(CFG.model)


def _capture_rhs(model, **kwargs):
  """The likelihood's RHS and initial state, from a solver that records
  them and returns y0."""
  got = {}

  def odeint(func, y0, t0, t1, **unused):
    got.update(func=func, y0=y0)
    return ode.ODESolution(y0, 0, 0, 0, True)
  nll_ode.make_ode_likelihood_fn(model, odeint=odeint, **kwargs)(
      IMAGES, u=U_TN, probe=PROBE)
  return got['func'], got['y0']


def _rel(got, want):
  want = np.asarray(want, np.float64)
  return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def test_one_rhs_matches_jax_ode_func(pair):
  """(f(t, x), eps^T (df/dx) eps) of one RHS evaluation against JAX's
  `ode_func` (`mulan_tpu/evals/nll_ode.py:174-183`) on the same state,
  embeddings and probe."""
  model, params, port = pair
  func, y0 = _capture_rhs(port)
  t = 0.37
  got = func(ode.f32(t), y0)
  d = CFG.model.n_pixels
  x = y0[:, :d].reshape(SHAPE).numpy()
  requant = np.round(np.clip(128 * (x + 1) - 0.5, 0, 255))
  with torch.no_grad():
    emb = latents.logits_to_embeddings(port.apply_encoder(requant),
                                       CFG.model.latent_k).numpy()

  @jax.jit
  def ode_func(p, x, emb, eps):
    fx, vjp_fn = jax.vjp(lambda xx: model.apply(
        {'params': p}, xx, emb, jnp.float32(t), True,
        method=model.reverse_ode), x)
    (eps_jac,) = vjp_fn(eps)
    return fx.reshape(B, d), jnp.sum(eps_jac * eps, axis=(1, 2, 3))
  fx, div = ode_func(params, x, emb, PROBE)
  assert _rel(got[:, :d], fx) <= RHS_RTOL
  assert _rel(got[:, d], div) <= RHS_RTOL, (got[:, d], div)


@pytest.mark.parametrize('dequantization', ['tn', 'uniform'])
def test_rk4_likelihood_matches_jax(pair, monkeypatch, dequantization):
  """log p, log q(eps) and the latent KL of a 2-step RK4 solve, with the
  dequantization draw and the probe injected on both sides; the port's
  called under `torch.inference_mode`, as the evaluation entry points are
  (the likelihood leaves it: autograd cannot save inference tensors)."""
  model, params, port = pair
  u = U_TN if dequantization == 'tn' else U_UNIFORM
  monkeypatch.setattr(jax.random, 'truncated_normal',
                      lambda *a, **k: jnp.asarray(U_TN))
  monkeypatch.setattr(jax.random, 'uniform',
                      lambda *a, **k: jnp.asarray(U_UNIFORM))
  monkeypatch.setattr(jax_nll, '_hutchinson_noise',
                      lambda *a: jnp.asarray(PROBE))
  want = jax.jit(jax_nll.make_ode_likelihood_fn(
      model, model.config, dequantization=dequantization,
      odeint=functools.partial(jax_rk4, num_steps=2)))(
          params, jax.random.PRNGKey(0), IMAGES)
  with torch.inference_mode():
    got = nll_ode.make_ode_likelihood_fn(
        port, dequantization=dequantization, odeint=RK4)(
            IMAGES, u=u, probe=PROBE)
  for name, a, b in zip(('log_p', 'log_q_eps', 'aux'), got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                               rtol=LIKELIHOOD_RTOL, err_msg=name)
  assert got[3] == {'nfe': 8, 'num_steps': 2, 'num_rejected': 0,
                    'success': True}
  if dequantization == 'uniform':
    assert not got[1].any()


def test_basis_probe_divergence_is_the_jacobian_trace(pair):
  """Summed over the 192 basis vectors of 8x8x3, the Hutchinson estimate is
  the trace of the drift's Jacobian (independent of JAX): 192 copies of
  one image, copy i probed with e_i, against
  `torch.autograd.functional.jacobian`."""
  _, _, port = pair
  d = CFG.model.n_pixels
  images = np.repeat(IMAGES[:1], d, axis=0)
  u = np.repeat(U_TN[:1], d, axis=0)
  basis = torch.eye(d).reshape(d, *CFG.model.image_shape)
  got = {}

  def odeint(func, y0, t0, t1, **unused):
    got['out'] = func(ode.f32(0.6), y0)
    got['x'] = y0[:1, :d].reshape(1, *CFG.model.image_shape)
    return ode.ODESolution(y0, 0, 0, 0, True)
  nll_ode.make_ode_likelihood_fn(port, odeint=odeint)(images, u=u,
                                                      probe=basis)
  requant = torch.round(torch.clip(128 * (got['x'] + 1) - 0.5, 0, 255))
  with torch.no_grad():
    emb = latents.logits_to_embeddings(port.apply_encoder(requant),
                                       CFG.model.latent_k)
  jac = torch.autograd.functional.jacobian(
      lambda x: port.reverse_ode(x, emb, ode.f32(0.6), True), got['x'])
  trace = torch.diagonal(jac.reshape(d, d)).sum()
  np.testing.assert_allclose(got['out'][:, d].sum().item(), trace.item(),
                             rtol=1e-5)


def test_dopri5_on_the_model_rhs_matches_scipy(pair):
  """The port's float32 DoPri5 on the likelihood's [x, delta log p] ODE
  against scipy's float64 RK45 on the same RHS (tests/test_evals.py's
  limits for JAX)."""
  _, _, port = pair
  func, y0 = _capture_rhs(port)
  ref = integrate.solve_ivp(
      lambda t, y: func(ode.f32(t), torch.tensor(
          y, dtype=torch.float32).reshape(y0.shape)).double().numpy().ravel(),
      (0, 1), y0.double().numpy().ravel(), rtol=1e-5, atol=1e-5,
      method='RK45')
  ref_y = ref.y[:, -1].reshape(y0.shape)
  sol = ode.odeint_dopri5(func, y0, 0.0, 1.0, rtol=1e-5, atol=1e-5)
  assert sol.success
  d = CFG.model.n_pixels
  # The final latents elementwise; delta log p to the solve's tolerance.
  np.testing.assert_allclose(sol.y[:, :d].numpy(), ref_y[:, :d], rtol=1e-2,
                             atol=2e-3)
  np.testing.assert_allclose(sol.y[:, d].numpy(), ref_y[:, d], rtol=1e-2,
                             atol=5e-2)


def test_bpd_offset_and_auto_is_group_match_jax():
  for deq in ('tn', 'uniform'):
    for num_is in (1, 2, 20):
      for gamma_min in (-13.3, -10.0, -5.0):
        assert nll_ode.bpd_offset(deq, num_is, gamma_min) == (
            jax_nll.bpd_offset(deq, num_is, gamma_min))
  with pytest.raises(ValueError):
    nll_ode.bpd_offset('gauss', 1)
  for num_is in range(1, 41):
    for cap in (1, 2, 3, 5, 8, 16, 32, 64, 128):
      assert nll_ode.auto_is_group(num_is, cap) == jax_nll.auto_is_group(
          num_is, cap), (num_is, cap)


# -- eval_bpd_ode's aggregation, on stand-in likelihoods ----------------------


def _fail_batches(n, failing):
  """n batches of 4 images; a batch fails its solve when its first pixel is
  255 (only those have one)."""
  rs = _rs(7)
  out = []
  for i in range(n):
    images = rs.randint(0, 255, size=(4, *CFG.model.image_shape))
    images[0, 0, 0, 0] = 255 if i in failing else 0
    out.append({'images': images.astype(np.uint8)})
  return out


def _jax_fake_likelihood(model, cfg, **unused):
  def likelihood(params, rng, images):
    rows = images.shape[0]
    x = images.reshape(rows, -1).astype(jnp.float32) / 255
    r = jnp.arange(rows, dtype=jnp.float32)
    stats = {'nfe': jnp.int32(13), 'num_steps': jnp.int32(2),
             'num_rejected': jnp.int32(1),
             'success': images.reshape(-1)[0] != 255}
    return (-100 * x.mean(1) - 0.3 * r, -50 * x.std(1) + 0.1 * r,
            x[:, 1] + 0.01 * r, stats)
  return likelihood


def _port_fake_likelihood(model, **unused):
  def likelihood(images, key=0):
    rows = images.shape[0]
    x = images.reshape(rows, -1).float() / 255
    r = torch.arange(rows, dtype=torch.float32)
    stats = {'nfe': 13, 'num_steps': 2, 'num_rejected': 1,
             'success': bool(images.reshape(-1)[0] != 255)}
    return (-100 * x.mean(1) - 0.3 * r, -50 * x.std(1, correction=0)
            + 0.1 * r, x[:, 1] + 0.01 * r, stats)
  return likelihood


def _both_estimates(monkeypatch, batches, **kwargs):
  """(JAX's eval_bpd_ode, the port's) on `batches` through the stand-ins,
  each a float or the RuntimeError it raised."""
  monkeypatch.setattr(jax_nll, 'make_ode_likelihood_fn',
                      _jax_fake_likelihood)
  monkeypatch.setattr(nll_ode, 'make_ode_likelihood_fn',
                      _port_fake_likelihood)
  for module in (jax_nll, nll_ode):
    monkeypatch.setattr(module.data_lib, 'create_one_time_eval_dataset',
                        lambda *a: iter(batches))
  jax_ex = types.SimpleNamespace(
      model=None, model_config=jax_config(CFG.model),
      state=types.SimpleNamespace(ema_params={}),
      mesh=mesh_lib.create_mesh(jax.devices()[:1]))
  port_model = types.SimpleNamespace(config=CFG.model,
                                     device=torch.device('cpu'))
  out = []
  for run in (lambda: jax_nll.eval_bpd_ode(jax_ex, None, **kwargs),
              lambda: nll_ode.eval_bpd_ode(None, None, model=port_model,
                                           **kwargs)):
    try:
      out.append(run())
    except RuntimeError as e:
      out.append(e)
  return out


@pytest.mark.parametrize('kwargs,failing,error', [
    (dict(num_is=1, num_iters=2), (), None),
    (dict(num_is=6), (), None),
    (dict(num_is=6, is_batch=4), (), None),
    (dict(num_is=3, dequantization='uniform'), (), None),
    (dict(num_is=2, on_solver_failure='warn'), (5,), None),
    (dict(num_is=2, on_solver_failure='warn'), (5, 9), 'excluded as'),
    (dict(num_is=2), (5,), 'hit max_steps=5000'),
    (dict(num_is=1, on_solver_failure='warn'), tuple(range(25)),
     'every ODE batch failed'),
], ids=['one_sample', 'auto_group', 'remainder_group', 'uniform',
        'warn_excludes_4pct', 'warn_raises_over_5pct', 'raise',
        'all_fail'])
def test_eval_bpd_ode_aggregation_matches_jax(monkeypatch, kwargs, failing,
                                              error):
  """The importance weighting (log-mean-exp of log p - log q), the latent
  KL averaged over samples, the offset, the groups (auto, with a
  remainder), and the failure rules: 'raise' raises, 'warn' drops the
  batch and raises when more than 5% of the batches were dropped."""
  want, got = _both_estimates(monkeypatch, _fail_batches(25, failing),
                              **kwargs)
  if error is None:
    assert isinstance(got, float) and isinstance(want, float), (got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
  else:
    assert isinstance(want, RuntimeError) and error in str(want), want
    assert str(got) == str(want)


# -- the probe's redraw policy, the sampler, the command lines ---------------


def _probe_seeds(monkeypatch, run):
  """The generator seed of every probe drawn during run()."""
  seeds = []
  real = nll_ode._hutchinson_noise

  def spy(generator, *args):
    seeds.append(generator.initial_seed())
    return real(generator, *args)
  monkeypatch.setattr(nll_ode, '_hutchinson_noise', spy)
  run()
  monkeypatch.setattr(nll_ode, '_hutchinson_noise', real)
  return seeds


def test_redraw_noise_policy(pair, monkeypatch):
  """rk4 redraws the probe at every RHS time (its two midpoint stages share
  a draw, keyed by t) unless deterministic_noise; dopri5 keeps one probe a
  solve unless redraw_noise."""
  _, _, port = pair
  seeds = _probe_seeds(monkeypatch, lambda: nll_ode.make_ode_likelihood_fn(
      port, odeint=RK4, redraw_noise=True)(IMAGES, 5, u=U_TN))
  # t = 0, 1/4, 1/4, 1/2 | 1/2, 3/4, 3/4, 1
  assert len(seeds) == 8 and len(set(seeds)) == 5
  assert seeds[1] == seeds[2] and seeds[3] == seeds[4] == seeds[3]
  assert seeds[5] == seeds[6]
  assert seeds == _probe_seeds(monkeypatch, lambda: (
      nll_ode.make_ode_likelihood_fn(port, odeint=RK4, redraw_noise=True)(
          IMAGES, 5, u=U_TN)))

  def estimate(**kwargs):
    return lambda: nll_ode.eval_bpd_ode(None, CFG, model=port, batch_size=B,
                                        max_batches=1, rk4_steps=1,
                                        rtol=1e-2, atol=1e-2, **kwargs)
  rk4 = _probe_seeds(monkeypatch, estimate(solver='rk4'))
  assert len(rk4) == 4 and len(set(rk4)) == 3
  assert len(_probe_seeds(monkeypatch, estimate(
      solver='rk4', deterministic_noise=True))) == 1
  assert len(_probe_seeds(monkeypatch, estimate(solver='dopri5'))) == 1
  redrawn = _probe_seeds(monkeypatch, estimate(solver='dopri5',
                                               redraw_noise=True))
  assert len(redrawn) > 7 and len(set(redrawn)) > 1


def test_ode_sampler_matches_jax(pair, monkeypatch):
  """`make_ode_sample_fn` with the prior and the embedding logits of the
  patched jax.random, on both sides with DoPri5 swapped for a 2-step RK4
  (the solvers are held against each other in tests/test_torch_ode.py)."""
  model, params, port = pair
  frozen_randomness(monkeypatch)
  n = 3
  monkeypatch.setattr(jax_nll, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      jax_rk4(f, y, t0, t1, num_steps=2)))
  monkeypatch.setattr(nll_ode, 'odeint_dopri5', lambda f, y, t0, t1, **k: (
      ode.odeint_rk4(f, y, t0, t1, num_steps=2)))
  want, want_nfe = jax.jit(lambda p: jax_nll.make_ode_sample_fn(
      model, model.config)(p, jax.random.PRNGKey(0), n))(params)
  got, nfe = nll_ode.make_ode_sample_fn(port)(
      n, logits=shaped_normal((n, CFG.model.latent_size)),
      prior=shaped_normal((n, *CFG.model.image_shape)))
  assert nfe == int(want_nfe) == 8
  assert _rel(got, want) <= LIKELIHOOD_RTOL


def test_command_lines_run_ode_on_cpu(pair, tmp_path, capsys):
  """`eval_bpd --bpd_eval_method=ode` (rk4 with 2 importance samples a
  solve, and dopri5) and `main --mode sample --sampler=ode` on a port
  checkpoint of the pair's weights."""
  _, _, port = pair
  ex = Experiment(CFG, device='cpu', state=port.state_dict())
  ex.state.step = 3
  ckpt_lib.CheckpointManager(tmp_path / 'ckpts').save(3, ex.state)
  config = ['--config=tiny_synthetic',
            '--config.model.with_fourier_features=False']
  common = [*config, '--device=cpu',
            f'--checkpoint_directory={tmp_path / "ckpts"}',
            '--config.data.synthetic_examples=32']
  bpds = []
  for extra in (['--solver=rk4', '--rk4_steps=2', '--n_is=2'],
                ['--n_is=1', '--rtol=1e-2', '--atol=1e-2']):
    eval_bpd.main(common + extra)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    bpd, ckpt = line.removeprefix('Test BPD:').split(' ckpt:')
    assert int(ckpt) == 3 and math.isfinite(float(bpd)), line
    bpds.append(float(bpd))
  main.main(['--mode=sample', *config, '--device=cpu',
             f'--workdir={tmp_path / "samples"}',
             f'--checkpoint={tmp_path / "ckpts"}', '--sampler=ode',
             '--sample_batch=4'])
  out = capsys.readouterr().out
  assert 'ode sampler nfe: ' in out, out
  png = (tmp_path / 'samples' / 'samples_ckpt3_ode.png').read_bytes()
  assert png.startswith(b'\x89PNG\r\n\x1a\n')
  assert os.path.getsize(tmp_path / 'samples' / 'samples_ckpt3_ode.png')
