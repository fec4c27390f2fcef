"""Noise schedules gamma(t), counterparts of `mulan_tpu/models/schedules.py`.

  * The scalar schedules of the baseline VDM (`SCALAR_SCHEDULES`, the JAX
    keys): gamma: (B,) -> (B,). Each returns `gamma_and_dgamma(t)` in one
    pass; where JAX takes dgamma/dt by `jax.jvp` (the monotone MLP and the
    BDM shapes), the closed form is written out here, built from the same
    tensors, so that autograd differentiates it with respect to the
    parameters (the VDM's loss weight 0.5 dgamma/dt mse needs that).
  * MuLAN's per-pixel schedules (`MULAN_SCHEDULES`): gamma: (B, width),
    (B,) -> (B, n_pixels), conditioned on the latent embedding, `width`
    wide. `poly_fixedend`: gmin + (gmax - gmin) P(t) / P(1), with
    P(t) = integral_0^t (a u^2 + b u + c)^2 du and per-pixel (a, b, c) from
    an MLP on the embedding, pinned at both ends; `learnable_nnet`: a
    monotone MLP on (embedding, t) whose ends are learned; `linear`: the
    fixed linear schedule at every pixel. dgamma/dt is in closed form for
    each, the MLP's through the chain rule (JAX takes it by `jax.jvp`).

Everything here is float32: gamma spans [-13.3, 5] and sigmoid(gamma)
reaches e^-13.3, far below bf16 resolution. The matmuls must not run in
TF32 either: PyTorch's default (`torch.backends.cuda.matmul.allow_tf32 =
False`) keeps them in full float32. `model.gamma_precision` sets the
learned networks' matmuls (`layers.gamma_matmul`), those of gamma and of
the closed-form dgamma/dt alike, as JAX's precision reaches both through
`jax.jvp`: 'highest' (the default) float32, 'high' three bf16 passes with
float32 accumulation, 'default' one. The blur schedules (`BLUR_SCHEDULES`:
sigma(t), learned or fixed between `SIGMA_MIN` and `SIGMA_MAX`) and
`NoiseSchedulePolynomialFixedend.inverse_sampling` (t reparameterized by
the schedule's arc length) are ported as JAX has them, though no model
uses them. No model blurs (`sigma_type` is 'no_blur' in every config), so
the blur's ends are JAX's defaults as constants, not config fields.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.layers import DenseMonotone, gamma_matmul


def _dsigmoid(a):
  s = torch.sigmoid(a)
  return s * (1.0 - s)


class NoiseScheduleScalar(nn.Module):
  """gamma(t) = b + |w| t (`schedules.py:NoiseScheduleScalar`)."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.config = config
    self.w = nn.Parameter(torch.empty(1))
    self.b = nn.Parameter(torch.empty(1))

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    t = t.float()
    slope = self.w[0].abs()
    return self.b[0] + slope * t, slope * torch.ones_like(t)


class NoiseScheduleFixedLinear(nn.Module):
  """gamma(t) = gmin + (gmax - gmin) t
  (`schedules.py:NoiseScheduleFixedLinear`); no parameters."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.config = config

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    c = self.config
    t = t.float()
    span = c.gamma_max - c.gamma_min
    return c.gamma_min + span * t, span * torch.ones_like(t)


class NoiseScheduleNNet(nn.Module):
  """The monotone MLP (`schedules.py:NoiseScheduleNNet`): a linear term
  plus a bounded correction,
    gamma(t) = l1(t) + l3(2 (sigmoid(l2(2 (t - 1/2))) - 1/2)) / n
  with `DenseMonotone` layers 1 -> 1, 1 -> n and n -> 1 (no bias), and in
  closed form
    dgamma/dt = |w1| + (2 / n) sum_j |w3_j| 2 sigmoid'(a_j) |w2_j|,
  a = l2(2 (t - 1/2)), what JAX's `jax.jvp` gives."""

  def __init__(self, config: ModelConfig, n_features: int = 1024):
    super().__init__()
    self.config = config
    self.n_features = n_features
    prec = self.precision = config.gamma_precision
    self.l1 = DenseMonotone(1, 1, precision=prec)
    self.l2 = DenseMonotone(1, n_features, precision=prec)
    self.l3 = DenseMonotone(n_features, 1, use_bias=False, precision=prec)

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    t = t.float().reshape(-1, 1)
    a = self.l2(2.0 * (t - 0.5))
    correction = self.l3(2.0 * (torch.sigmoid(a) - 0.5)) / self.n_features
    gamma = self.l1(t) + correction
    slope = gamma_matmul(2.0 * _dsigmoid(a) * 2.0 * self.l2.kernel.abs(),
                         self.l3.kernel.abs(), self.precision) / (
                             self.n_features)
    dgamma = self.l1.kernel.abs() + slope
    return gamma.squeeze(-1), dgamma.squeeze(-1)


class NoiseScheduleBDM(nn.Module):
  """The fixed sigmoid-shaped schedules (`schedules.py:NoiseScheduleBDM`):
  gamma = gmin + (gmax - gmin) g(t) with g = 2 sigmoid(t) - 1 ('bad_bdm')
  or 2 - 2 sigmoid(10 (1 - t)) ('good_bdm'); no parameters."""

  def __init__(self, config: ModelConfig, good: bool = False):
    super().__init__()
    self.config = config
    self.good = good

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    c = self.config
    t = t.float()
    span = c.gamma_max - c.gamma_min
    if self.good:
      g = 2 - 2 * torch.sigmoid(10.0 * (1 - t))
      dg = 20.0 * _dsigmoid(10.0 * (1 - t))
    else:
      g = 2 * torch.sigmoid(t) - 1
      dg = 2.0 * _dsigmoid(t)
    return c.gamma_min + span * g, span * dg


SCALAR_SCHEDULES = {
    'learnable_scalar': NoiseScheduleScalar,
    'fixed': NoiseScheduleFixedLinear,
    'learnable_nnet': NoiseScheduleNNet,
    'bad_bdm': NoiseScheduleBDM,
    'good_bdm': functools.partial(NoiseScheduleBDM, good=True),
}


# The fixed blur schedule's ends: JAX's `sigma_min` and `sigma_max`, which
# every JAX config leaves at these values.
SIGMA_MIN = 0.0
SIGMA_MAX = 20.0


class BlurScheduleScalar(nn.Module):
  """sigma(t) = sigmoid(b + |w| t), w = 1 and b = 0 at the start
  (`schedules.py:BlurScheduleScalar`); dsigma/dt = sigmoid'(b + |w| t)
  |w|."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.config = config
    self.w = nn.Parameter(torch.ones(1))
    self.b = nn.Parameter(torch.zeros(1))

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    slope = self.w[0].abs()
    a = self.b[0] + slope * t.float()
    return torch.sigmoid(a), _dsigmoid(a) * slope


class BlurScheduleFixedLinear(nn.Module):
  """sigma(t) = SIGMA_MIN + (SIGMA_MAX - SIGMA_MIN) t
  (`schedules.py:BlurScheduleFixedLinear`); no parameters."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.config = config

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    t = t.float()
    span = SIGMA_MAX - SIGMA_MIN
    return SIGMA_MIN + span * t, span * torch.ones_like(t)


BLUR_SCHEDULES = {
    'learnable_scalar': BlurScheduleScalar,
    'fixed': BlurScheduleFixedLinear,
}


class MulanSchedule(nn.Module):
  """Base of the per-pixel schedules: `forward` is gamma alone, and
  `elbo_gammas` evaluates the schedule at 0, at 1 and (with dgamma/dt) at
  t, three passes as in JAX (`schedules.py:187-197`)."""

  def forward(self, embedding, t):
    """(B, width), (B,) -> gamma (B, n_pixels), pixels in NHWC order."""
    return self.gamma_and_dgamma(embedding, t)[0]

  def elbo_gammas(self, embedding, t):
    """(gamma_0, gamma_1, gamma_t, dgamma_t/dt), each (B, n_pixels)."""
    g_t, dg_t = self.gamma_and_dgamma(embedding, t)
    return (self(embedding, torch.zeros_like(t)),
            self(embedding, torch.ones_like(t)), g_t, dg_t)


class NoiseSchedulePolynomialFixedend(MulanSchedule):
  # The t grid of `inverse_sampling`.
  n_inverse_timesteps = 1000

  def __init__(self, config: ModelConfig, embedding_width: int):
    super().__init__()
    self.config = config
    n = config.n_pixels
    self.dense_1 = nn.Linear(embedding_width, n)
    self.dense_2 = nn.Linear(n, n)
    self.dense_out_a = nn.Linear(n, n)
    self.dense_out_b = nn.Linear(n, n)
    self.dense_out_c = nn.Linear(n, n)

  def _dense(self, layer, x):
    """`layer(x)` with its product at `gamma_precision`."""
    precision = self.config.gamma_precision
    if precision == 'highest':
      return layer(x)
    return gamma_matmul(x, layer.weight.t(), precision) + layer.bias

  def _coefficients(self, embedding):
    h = F.silu(self._dense(self.dense_1, embedding.float()))
    h = F.silu(self._dense(self.dense_2, h))
    return (self._dense(self.dense_out_a, h),
            self._dense(self.dense_out_b, h),
            1e-3 + F.softplus(self._dense(self.dense_out_c, h)))

  @staticmethod
  def _integral(a, b, c, t):
    """P(t) = integral of (a u^2 + b u + c)^2 from 0 to t."""
    return ((a * a) * (t ** 5) / 5.0
            + (b * b + 2 * a * c) * (t ** 3) / 3.0
            + a * b * (t ** 4) / 2.0
            + b * c * (t ** 2)
            + (c * c) * t)

  @staticmethod
  def _scale(a, b, c):
    """P(1)."""
    return ((a * a) / 5.0 + (b * b + 2 * a * c) / 3.0 + a * b / 2.0
            + b * c + c * c)

  def _span(self):
    return self.config.gamma_max - self.config.gamma_min

  def gamma_and_dgamma(self, embedding, t):
    a, b, c = self._coefficients(embedding)
    t = t.reshape(-1, 1).float()
    inv_scale = 1.0 / self._scale(a, b, c)
    gamma = (self.config.gamma_min
             + self._span() * self._integral(a, b, c, t) * inv_scale)
    quad = a * t * t + b * t + c
    return gamma, self._span() * (quad * quad) * inv_scale

  def elbo_gammas(self, embedding, t):
    """The endpoints are pinned by construction (P(0) = 0, P(1)/P(1) = 1),
    so they are constants and the MLP runs once."""
    g_t, dg_t = self.gamma_and_dgamma(embedding, t)
    g_0 = torch.full_like(g_t, self.config.gamma_min)
    g_1 = torch.full_like(g_t, self.config.gamma_max)
    return g_0, g_1, g_t, dg_t

  def inverse_sampling(self, embedding, targets):
    """(new_t (B,), the total length (B,)): t reparameterized by arc length
    (`schedules.py:297-316`). On a grid of `n_inverse_timesteps` t in
    [0, 1], the length of the curve gamma(z, t) is the trapezoidal integral
    of |dgamma/dt| (the 2-norm over the pixels); new_t is the grid point
    whose length from 0 is nearest to `targets` (B,) times the total."""
    if embedding.dim() != 2 or targets.dim() != 1:
      raise ValueError('inverse_sampling takes embedding (B, width) and '
                       'targets (B,)')
    n = self.n_inverse_timesteps
    a, b, c = (x[:, :, None] for x in self._coefficients(embedding))
    grid = torch.linspace(0.0, 1.0, n, device=embedding.device)
    quad = a * grid * grid + b * grid + c
    dgamma = self._span() * quad * quad / self._scale(a, b, c)
    dl_dt = torch.linalg.vector_norm(dgamma, ord=2, dim=1)
    dl_dt = 0.5 * (dl_dt[:, :-1] + dl_dt[:, 1:])
    cum = F.pad(torch.cumsum(dl_dt, dim=1) / (n - 1), (1, 0))
    idx = torch.argmin(torch.square(cum - cum[:, -1:] * targets[:, None]),
                       dim=1)
    return idx.float() / (n - 1), cum[:, -1]


class MulanScheduleNNet(MulanSchedule):
  """The monotone MLP on (embedding, t) (`schedules.py:319-356`):
    gamma = l1(t) + l3(s(l_int(s(l2(2 ((z, t) - 1/2)))))) / n,
  s(a) = 2 (sigmoid(a) - 1/2), with `DenseMonotone` layers 1 -> 1 (`l1`),
  (width + 1) -> n (`l2`), n -> n (`l_int`) and n -> n_pixels without a
  bias (`l3`), n = n_pixels. Its ends are not pinned: g_0 and g_1 carry
  gradient. dgamma/dt by the chain rule, from the same tensors:
    |w1| + (s'(a_int) * ((s'(a2) * 2 |W2[t]|) @ |W_int|)) @ |W3| / n,
  s' = 2 sigmoid', W2[t] the t row of l2's kernel."""

  def __init__(self, config: ModelConfig, embedding_width: int):
    super().__init__()
    self.config = config
    n = self.n_features = config.n_pixels
    prec = self.precision = config.gamma_precision
    self.l1 = DenseMonotone(1, 1, precision=prec)
    self.l2 = DenseMonotone(embedding_width + 1, n, precision=prec)
    self.l_int = DenseMonotone(n, n, precision=prec)
    self.l3 = DenseMonotone(n, n, use_bias=False, precision=prec)

  def _forward(self, embedding, t):
    """(gamma, l2's and l_int's pre-activations)."""
    t = t.reshape(-1, 1).float()
    a2 = self.l2(2.0 * (torch.cat([embedding.float(), t], dim=1) - 0.5))
    a_int = self.l_int(2.0 * (torch.sigmoid(a2) - 0.5))
    gamma = self.l1(t) + self.l3(2.0 * (torch.sigmoid(a_int) - 0.5)) / (
        self.n_features)
    return gamma, a2, a_int

  def forward(self, embedding, t):
    return self._forward(embedding, t)[0]

  def gamma_and_dgamma(self, embedding, t):
    gamma, a2, a_int = self._forward(embedding, t)
    d2 = 2.0 * _dsigmoid(a2) * (2.0 * self.l2.kernel[-1].abs())
    d_int = 2.0 * _dsigmoid(a_int) * gamma_matmul(
        d2, self.l_int.kernel.abs(), self.precision)
    dgamma = self.l1.kernel.abs() + gamma_matmul(
        d_int, self.l3.kernel.abs(), self.precision) / self.n_features
    return gamma, dgamma


class MulanScheduleLinear(MulanSchedule):
  """gmin + (gmax - gmin) t at every pixel (`schedules.py:359-376`); no
  parameters."""

  def __init__(self, config: ModelConfig, embedding_width: int):
    super().__init__()
    del embedding_width
    self.config = config

  def gamma_and_dgamma(self, embedding, t):
    c = self.config
    ones = torch.ones((embedding.shape[0], c.n_pixels), device=t.device)
    span = c.gamma_max - c.gamma_min
    return (c.gamma_min + span * t.reshape(-1, 1).float()) * ones, (
        span * ones)


# `gamma_type` -> MuLAN's schedule (`schedules.py:379`).
MULAN_SCHEDULES = {
    'linear': MulanScheduleLinear,
    'learnable_nnet': MulanScheduleNNet,
    'poly_fixedend': NoiseSchedulePolynomialFixedend,
}
