"""The port's ODE solvers and MuLAN's SDE / probability-flow ODE methods
against the JAX package's, float32 on the CPU.

The solvers are held against JAX's on closed-form right-hand sides (the
cases of tests/test_ode.py), against scipy's RK45 and against their own
order of convergence; JAX's DoPri5 is never compiled over a network. The
model methods run one flax init of the tiny config (8x8 images, 32
channels, 2 layers) transplanted into the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate
import torch

from mulan_tpu.ops import ode as jax_ode
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.config import tiny_config
from mulan_tpu_torch.ops import ode
from torch_port_helpers import seeded_pair

# The solvers' states: float32 on both sides, the same operations in the
# same order (XLA's fused multiply-adds as `ops/ode.py:_axpy`); only the
# closed forms' transcendental functions may round differently.
SOLVER_RTOL = 1e-6
# Network outputs, as a fraction of the output's largest magnitude: float32
# on both sides, convolutions summed in another order.
NET_RTOL = 1e-5
B = 2

_A = np.linspace(0.5, 1.5, 8).astype(np.float32)

# (name, JAX RHS, port RHS, y0, t0, t1, solver arguments): the exponential,
# reverse-time and nonlinear cases of tests/test_ode.py.
CASES = [
    ('exponential', lambda t, y: -y, lambda t, y: -y,
     np.ones(4, np.float32), 0.0, 1.0, dict(rtol=1e-6, atol=1e-8)),
    ('reverse_time', lambda t, y: y, lambda t, y: y,
     np.full(3, 2.0, np.float32), 1.0, 0.0, dict(rtol=1e-6, atol=1e-8)),
    ('nonlinear', lambda t, y: jnp.sin(3 * t) * y - 0.5 * y ** 3 + _A,
     lambda t, y: torch.sin(3 * t) * y - 0.5 * y ** 3 + torch.from_numpy(_A),
     np.linspace(-1, 1, 8).astype(np.float32), 0.0, 1.0,
     dict(rtol=1e-5, atol=1e-5)),
    ('nonlinear_loose', lambda t, y: jnp.sin(3 * t) * y - 0.5 * y ** 3 + _A,
     lambda t, y: torch.sin(3 * t) * y - 0.5 * y ** 3 + torch.from_numpy(_A),
     np.linspace(-1, 1, 8).astype(np.float32), 0.0, 1.0,
     dict(rtol=1e-3, atol=1e-4)),
    ('step_budget', lambda t, y: -y, lambda t, y: -y,
     np.ones(2, np.float32), 0.0, 1.0,
     dict(max_steps=2, rtol=1e-10, atol=1e-12, first_step=1e-6)),
]


def _err_norms(func, y0, t0, t1, **kw):
  """The port's error norm at every attempted step, for failure messages."""
  norms = []
  real = torch.sqrt

  def spy(x):
    out = real(x)
    if out.dim() == 0:
      norms.append(float(out))
    return out
  torch.sqrt = spy
  try:
    ode.odeint_dopri5(func, torch.from_numpy(y0), t0, t1, **kw)
  finally:
    torch.sqrt = real
  return norms


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_dopri5_and_rk4_match_jax(case):
  """The same accepted and rejected steps, RHS evaluations and success flag
  as JAX's DoPri5, y at SOLVER_RTOL; RK4 likewise."""
  _, jax_rhs, port_rhs, y0, t0, t1, kw = case
  want = jax.jit(lambda y: jax_ode.odeint_dopri5(jax_rhs, y, t0, t1, **kw))(
      jnp.asarray(y0))
  got = ode.odeint_dopri5(port_rhs, torch.from_numpy(y0), t0, t1, **kw)
  counts = (got.num_steps, got.num_rejected, got.nfe, got.success)
  want_counts = (int(want.num_steps), int(want.num_rejected), int(want.nfe),
                 bool(want.success))
  assert counts == want_counts, (
      f'(steps, rejected, nfe, success) {counts} against JAX '
      f'{want_counts}; the port\'s error norms: '
      f'{_err_norms(port_rhs, y0, t0, t1, **kw)}')
  np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                             rtol=SOLVER_RTOL)

  want = jax_ode.odeint_rk4(jax_rhs, jnp.asarray(y0), t0, t1, num_steps=8)
  got = ode.odeint_rk4(port_rhs, torch.from_numpy(y0), t0, t1, num_steps=8,
                       **kw)
  assert (got.num_steps, got.num_rejected, got.nfe, got.success) == (
      8, 0, 32, True)
  np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                             rtol=SOLVER_RTOL)


def test_dopri5_matches_scipy_rk45():
  """Van-der-Pol-like RHS against scipy's RK45 at the same tolerances
  (tests/test_ode.py's limits)."""
  def rhs_np(t, y):
    return np.sin(3 * t) * y - 0.5 * y ** 3 + _A

  y0 = np.linspace(-1, 1, 8).astype(np.float32)
  ref = integrate.solve_ivp(rhs_np, (0, 1), y0, rtol=1e-3, atol=1e-4,
                            method='RK45')
  got = ode.odeint_dopri5(CASES[2][2], torch.from_numpy(y0), 0.0, 1.0,
                          rtol=1e-3, atol=1e-4)
  assert got.success
  np.testing.assert_allclose(got.y.numpy(), ref.y[:, -1], rtol=1e-3,
                             atol=1e-4)


def test_rk4_is_fourth_order():
  """Halving the step shrinks the global error ~16x."""
  def rhs(t, y):
    return torch.sin(3 * t) * y - 0.5 * y ** 3

  y0 = torch.linspace(-1, 1, 8)
  exact = ode.odeint_dopri5(rhs, y0, 0.0, 1.0, rtol=1e-8,
                            atol=1e-10).y.double()
  errs = [(ode.odeint_rk4(rhs, y0, 0.0, 1.0, num_steps=n).y.double()
           - exact).abs().max().item() for n in (8, 16, 32)]
  assert errs[0] / errs[1] > 8, errs  # float32's floor softens the 16x
  assert errs[1] / errs[2] > 4, errs


# -- the model's SDE / ODE methods --------------------------------------------


@pytest.fixture(scope='module')
def pair():
  return seeded_pair(tiny_config())


def _inputs(cfg, seed=0):
  rs = np.random.RandomState(seed)
  x = rs.standard_normal((B, *cfg.image_shape)).astype(np.float32)
  emb = latents.logits_to_embeddings(torch.from_numpy(
      rs.standard_normal((B, cfg.latent_size)).astype(np.float32)),
                                     cfg.latent_k).numpy()
  return x, emb


def _assert_net_close(got, want, what):
  want = np.asarray(want, np.float64)
  err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
  assert err <= NET_RTOL, (what, err)


@pytest.mark.parametrize('high_precision', [False, True])
def test_reverse_ode_matches_jax(pair, high_precision):
  """The drift at t near 0 (where sigma^2 <= 1e-3 and the log-domain sigma
  takes over), mid-way and near 1. The guard changes the drift near t = 0
  only."""
  model, params, port = pair
  x, emb = _inputs(port.config)
  fn = jax.jit(lambda p, x, e, t: model.apply(
      {'params': p}, x, e, t, high_precision, method=model.reverse_ode))
  for t in (1e-3, 0.5, 0.999):
    want = fn(params, x, emb, jnp.float32(t))
    with torch.no_grad():
      got, other = (port.reverse_ode(torch.from_numpy(x),
                                     torch.from_numpy(emb), ode.f32(t), hp)
                    for hp in (high_precision, not high_precision))
    _assert_net_close(got, want, t)
    assert torch.equal(got, other) == (t != 1e-3), t


def test_sde_and_score_fn_match_jax(pair):
  model, params, port = pair
  x, emb = _inputs(port.config)
  g = 3 * np.random.RandomState(1).standard_normal(x.shape).astype(
      np.float32)
  want = jax.jit(lambda p, x, e: model.apply(
      {'params': p}, x, e, jnp.float32(0.3), method=model.sde))(
          params, x, emb)
  with torch.no_grad():
    got = port.sde(torch.from_numpy(x), torch.from_numpy(emb), ode.f32(0.3))
  for name, a, b in zip(('drift', 'diffusion'), got, want):
    _assert_net_close(a, b, name)
  want = jax.jit(lambda p, x, g, e: model.apply(
      {'params': p}, x, g, e, method=model.score_fn))(params, x, g, emb)
  with torch.no_grad():
    got = port.score_fn(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(emb))
  _assert_net_close(got, want, 'score')


def test_score_jvp_matches_jax_and_needs_plain_ops(pair, monkeypatch):
  """(score, d score / dz . v) against `jax.jvp`; with the kernels on a CUDA
  device it raises before any work."""
  model, params, port = pair
  x, emb = _inputs(port.config)
  rs = np.random.RandomState(2)
  g = 3 * rs.standard_normal(x.shape).astype(np.float32)
  v = rs.standard_normal(x.shape).astype(np.float32)
  want = jax.jit(lambda p, x, g, e, v: model.apply(
      {'params': p}, x, g, e, v, method=model.score_jvp))(
          params, x, g, emb, v)
  got = port.score_jvp(*(torch.from_numpy(a) for a in (x, g, emb, v)))
  _assert_net_close(got[0], want[0], 'score')
  _assert_net_close(got[1], want[1], 'jvp')

  monkeypatch.setattr(type(port), 'device', torch.device('cuda', 0))
  monkeypatch.setattr(port, 'config',
                      dataclasses.replace(port.config, use_kernels=True))
  with pytest.raises(NotImplementedError, match='forward-mode'):
    port.score_jvp(*(torch.from_numpy(a) for a in (x, g, emb, v)))
