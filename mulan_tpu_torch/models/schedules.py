"""Noise schedules gamma(t), counterparts of `mulan_tpu/models/schedules.py`.

  * The scalar schedules of the baseline VDM (`SCALAR_SCHEDULES`, the JAX
    keys): gamma: (B,) -> (B,). Each returns `gamma_and_dgamma(t)` in one
    pass; where JAX takes dgamma/dt by `jax.jvp` (the monotone MLP and the
    BDM shapes), the closed form is written out here, built from the same
    tensors, so that autograd differentiates it with respect to the
    parameters (the VDM's loss weight 0.5 dgamma/dt mse needs that).
  * MuLAN's per-pixel `poly_fixedend`: gamma(z, t) = gmin + (gmax - gmin)
    P(t) / P(1), with P(t) = integral_0^t (a u^2 + b u + c)^2 du and
    per-pixel (a, b, c) from an MLP on the latent embedding; dgamma/dt has a
    closed form.

Everything here is float32: gamma spans [-13.3, 5] and sigmoid(gamma)
reaches e^-13.3, far below bf16 resolution. The matmuls must not run in
TF32 either: PyTorch's default (`torch.backends.cuda.matmul.allow_tf32 =
False`) keeps them in full float32. The blur schedules (`BLUR_SCHEDULES`)
are used by no model and are not ported (ROADMAP.md Queue A, model
variants).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.layers import DenseMonotone


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
    self.l1 = DenseMonotone(1, 1)
    self.l2 = DenseMonotone(1, n_features)
    self.l3 = DenseMonotone(n_features, 1, use_bias=False)

  def forward(self, t):
    return self.gamma_and_dgamma(t)[0]

  def gamma_and_dgamma(self, t):
    t = t.float().reshape(-1, 1)
    a = self.l2(2.0 * (t - 0.5))
    correction = self.l3(2.0 * (torch.sigmoid(a) - 0.5)) / self.n_features
    gamma = self.l1(t) + correction
    slope = (2.0 * _dsigmoid(a) * 2.0 * self.l2.kernel.abs()) @ (
        self.l3.kernel.abs()) / self.n_features
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


class NoiseSchedulePolynomialFixedend(nn.Module):

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.config = config
    n = config.n_pixels
    self.dense_1 = nn.Linear(config.latent_size, n)
    self.dense_2 = nn.Linear(n, n)
    self.dense_out_a = nn.Linear(n, n)
    self.dense_out_b = nn.Linear(n, n)
    self.dense_out_c = nn.Linear(n, n)

  def _coefficients(self, embedding):
    h = F.silu(self.dense_1(embedding.float()))
    h = F.silu(self.dense_2(h))
    return (self.dense_out_a(h), self.dense_out_b(h),
            1e-3 + F.softplus(self.dense_out_c(h)))

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

  def forward(self, embedding, t):
    """(B, latent), (B,) -> gamma (B, n_pixels), pixels in NHWC order."""
    return self.gamma_and_dgamma(embedding, t)[0]

  def gamma_and_dgamma(self, embedding, t):
    a, b, c = self._coefficients(embedding)
    t = t.reshape(-1, 1).float()
    inv_scale = 1.0 / self._scale(a, b, c)
    gamma = (self.config.gamma_min
             + self._span() * self._integral(a, b, c, t) * inv_scale)
    quad = a * t * t + b * t + c
    return gamma, self._span() * (quad * quad) * inv_scale

  def elbo_gammas(self, embedding, t):
    """(gamma_0, gamma_1, gamma_t, dgamma_t/dt), each (B, n_pixels).

    The endpoints are pinned by construction (P(0) = 0, P(1)/P(1) = 1), so
    they are constants and the MLP runs once.
    """
    g_t, dg_t = self.gamma_and_dgamma(embedding, t)
    g_0 = torch.full_like(g_t, self.config.gamma_min)
    g_1 = torch.full_like(g_t, self.config.gamma_max)
    return g_0, g_1, g_t, dg_t
