"""`model.gamma_precision` of the port's gamma networks
(`mulan_tpu/models/schedules.py:97-107`, `:221-230`, `:334-342`): every
product of the three learned networks (the VDM's monotone MLP, MuLAN's
`poly_fixedend` and `learnable_nnet`), gamma's and the closed-form
dgamma/dt's, forward and backward, against its float64 value within the
bound of its precision; the precisions ranked by their errors; and
'highest' against JAX's networks, which on the CPU compute every precision
in float32 (XLA's CPU backend ignores the precision).

The bounds, on |computed - exact| relative to (|x| @ |w|) for an inner
dimension n, u = 2^-24 the float32 unit roundoff:
  'highest' (float32):                     1.1 (n + 3) u
  'high' (hi.hi + hi.lo + lo.hi of the bf16 splits): the dropped lo.lo and
     the lo parts' own rounding, 3.01 x 2^-16, rounded up to 4 x 2^-16,
     plus 1.1 (n + 3) u;
  'default' (one bf16 pass): each operand rounded by at most 2^-8,
     2^-7 + 2^-16 for the product, plus 1.1 (n + 3) u.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulan_tpu.models import schedules as jax_schedules
from mulan_tpu_torch.models import layers, schedules
from mulan_tpu_torch.models.config import tiny_config
from torch_port_helpers import jax_config

PRECISIONS = ('highest', 'high', 'default')
U = 2.0 ** -24


def bound(precision: str, n: int) -> float:
  acc = 1.1 * (n + 3) * U
  return {'highest': acc, 'high': 4 * 2.0 ** -16 + acc,
          'default': 2.0 ** -7 + 2.0 ** -16 + acc}[precision]


def _rand(shape, seed, scale=1.0):
  return torch.from_numpy(
      scale * np.random.RandomState(seed).standard_normal(shape)).float()


def _excess(got, x, w, precision):
  """max over the outputs of |got - x @ w| / bound, x @ w in float64."""
  exact = x.double() @ w.double()
  scale = x.double().abs() @ w.double().abs()
  return ((got.double() - exact).abs()
          / (bound(precision, x.shape[-1]) * scale + 1e-300)).max().item()


@pytest.mark.parametrize('precision', PRECISIONS)
def test_gamma_matmul_and_its_gradients_within_their_bounds(precision):
  """(16, 192) @ (192, 192), and the two products of its backward, each
  within its precision's bound of the float64 product."""
  x = _rand((16, 192), 0).requires_grad_()
  w = _rand((192, 192), 1, 0.1).requires_grad_()
  g = _rand((16, 192), 2)
  y = layers.gamma_matmul(x, w, precision)
  y.backward(g)
  assert _excess(y.detach(), x.detach(), w.detach(), precision) <= 1.0
  assert _excess(x.grad, g, w.detach().t(), precision) <= 1.0
  assert _excess(w.grad, x.detach().t(), g, precision) <= 1.0
  if precision == 'highest':
    assert torch.equal(y, x @ w)


def test_precisions_rank_by_error():
  """Each mode computes what it says: 'default' errs more than 'high',
  which errs more than float32, on the same product."""
  x, w = _rand((16, 192), 3), _rand((192, 192), 4, 0.1)
  exact = x.double() @ w.double()
  err = {p: (layers.gamma_matmul(x, w, p).double() - exact).abs().max()
         for p in PRECISIONS}
  assert err['highest'] < err['high'] < err['default'], err
  with pytest.raises(ValueError, match='gamma_precision'):
    layers.gamma_matmul(x, w, 'fast')


# -- the networks ----------------------------------------------------------------

NETWORKS = {
    'vdm_nnet': ('learnable_nnet', 'vdm'),
    'poly_fixedend': ('poly_fixedend', 'mulan'),
    'mulan_nnet': ('learnable_nnet', 'mulan'),
}
# gamma_matmul calls of one gamma_and_dgamma: the layers' products and the
# closed-form dgamma/dt's ('poly_fixedend' has a closed form without one).
PRODUCTS = {'vdm_nnet': 4, 'poly_fixedend': 5, 'mulan_nnet': 6}
B = 4


def _network(name, precision):
  """(port network with seeded parameters, its JAX module's params, the
  JAX module at `precision`, inputs)."""
  gamma_type, kind = NETWORKS[name]
  cfg = tiny_config(gamma_type=gamma_type, gamma_precision=precision)
  if kind == 'vdm':
    port = schedules.SCALAR_SCHEDULES[gamma_type](cfg)
    jax_module = jax_schedules.SCALAR_SCHEDULES[gamma_type](jax_config(cfg))
    inputs = (torch.linspace(0.0, 1.0, 9),)
  else:
    port = schedules.MULAN_SCHEDULES[gamma_type](cfg, cfg.latent_size)
    jax_module = jax_schedules.MULAN_SCHEDULES[gamma_type](jax_config(cfg))
    inputs = (_rand((B, cfg.latent_size), 5),
              torch.tensor([0.0, 0.3, 0.7, 1.0]))
  flax_params = {}
  for i, (key, p) in enumerate(sorted(port.state_dict().items())):
    fan_in = p.shape[-1] if key.endswith('weight') else p.shape[0]
    value = _rand(tuple(p.shape), 10 + i, 1.0 / np.sqrt(fan_in))
    if key == 'l1.bias':
      value = torch.tensor([cfg.gamma_min])
    p.copy_(value)
    module, leaf = key.split('.')
    leaf, value = (('kernel', value.t()) if leaf == 'weight'
                   else (leaf, value))
    flax_params.setdefault(module, {})[leaf] = jnp.asarray(value.numpy())
  return port, flax_params, jax_module, inputs


@pytest.mark.parametrize('precision', ['high', 'default'])
@pytest.mark.parametrize('name', list(NETWORKS))
def test_every_network_product_within_its_bound(monkeypatch, name,
                                                precision):
  """gamma_and_dgamma at the precision: each of its products within the
  bound of the float64 product of the same operands, every product of the
  network counted; gamma and dgamma/dt near the network's at 'highest'
  (within 1e-4 of their largest value at 'high', 3e-2 at 'default')."""
  port, _, _, inputs = _network(name, precision)
  calls = []
  real = layers.gamma_matmul

  def recording(x, w, p='highest'):
    out = real(x, w, p)
    calls.append((x.detach().clone(), w.detach().clone(), p, out.detach()))
    return out
  monkeypatch.setattr(layers, 'gamma_matmul', recording)
  monkeypatch.setattr(schedules, 'gamma_matmul', recording)
  gamma, dgamma = port.gamma_and_dgamma(*inputs)
  assert len(calls) == PRODUCTS[name]
  for x, w, p, out in calls:
    assert p == precision
    assert _excess(out, x, w, precision) <= 1.0
  monkeypatch.setattr(layers, 'gamma_matmul', real)
  monkeypatch.setattr(schedules, 'gamma_matmul', real)

  want = _network(name, 'highest')[0].gamma_and_dgamma(*inputs)
  for got, w, what in zip((gamma, dgamma), want, ('gamma', 'dgamma')):
    rel = ((got - w).abs().max() / w.abs().max()).item()
    assert rel <= (1e-4 if precision == 'high' else 3e-2), (what, rel)


@pytest.mark.parametrize('jax_precision', PRECISIONS)
@pytest.mark.parametrize('name', list(NETWORKS))
def test_highest_matches_jax(name, jax_precision):
  """The port at 'highest' against JAX's network at each precision (all
  float32 on the CPU): gamma and dgamma/dt (JAX's by `jax.jvp`) within
  1e-5 of their largest value, and gamma alone."""
  port, flax_params, _, inputs = _network(name, 'highest')
  jax_module = _network(name, jax_precision)[2]
  args = [jnp.asarray(x.numpy()) for x in inputs]
  want = jax_module.apply({'params': flax_params}, *args,
                          method=jax_module.gamma_and_dgamma)
  want_gamma = jax_module.apply({'params': flax_params}, *args)
  with torch.no_grad():
    got = port.gamma_and_dgamma(*inputs)
    got_gamma = port(*inputs)
  for g, w in zip((*got, got_gamma), (*want, want_gamma)):
    w = np.asarray(w)
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


def test_precision_reaches_every_gamma_network_of_a_model():
  """A MuLAN and a VDM built at 'high': their schedule networks' layers
  carry it."""
  from mulan_tpu_torch.models import make_model
  for vdm_type, gamma_type in (('mulan_velocity', 'learnable_nnet'),
                               ('mulan_velocity', 'poly_fixedend'),
                               ('vdm', 'learnable_nnet')):
    cfg = dataclasses.replace(tiny_config(gamma_type=gamma_type),
                              gamma_precision='high')
    gamma = make_model(vdm_type, cfg).gamma
    dense = [m for m in gamma.modules()
             if isinstance(m, layers.DenseMonotone)]
    assert all(m.precision == 'high' for m in dense), vdm_type
    assert gamma.config.gamma_precision == 'high'
