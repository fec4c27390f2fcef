"""The baseline VDM with a scalar noise schedule, counterpart of
`mulan_tpu/models/vdm.py` (`VDM`, `sample_times`).

gamma(t) is one number per time (`models/schedules.py:SCALAR_SCHEDULES`);
the score UNet is the flagship's, conditioned on gamma_t and on one column
of conditioning (zeros: the port has no augmentation, whose bit JAX feeds
there). There is no latent: `apply_encoder` returns zero logits and
`conditional_sample` ignores its embedding, as in JAX.

Public methods take and return NHWC, as `MuLAN`'s do. Noise can be passed
in (`eps0`, `eps`, `dropout_seed`); what is not passed is drawn from
`generator`, which must live on the model's device. The reconstruction term
hands the decoder log-likelihood g_0 = gamma(0) as one number that needs a
gradient (the schedule's parameters are trained), so a train step runs the
decoder backward (K5) with a broadcast g_0, reduced in the kernel.

`reparam_type='input'` reads the UNet's output as x-hat: the sampler and the
probability-flow ODE convert it to eps-hat, and the discrete-time loss takes
the x-MSE weight, while the MSE itself stays against eps, as JAX reproduces
from the reference (`mulan_tpu/models/vdm.py:82-110`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mulan_tpu_torch.models import encdec as encdec_lib
from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.outputs import ELBOOutput
from mulan_tpu_torch.models.schedules import SCALAR_SCHEDULES
from mulan_tpu_torch.models.unet import UNet


def sample_times(n: int, *, antithetic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
  """n diffusion times in [0, 1): antithetic (low-discrepancy), t_i = (u +
  i / n) mod 1 for one uniform u, or i.i.d. uniform."""
  if not antithetic:
    return torch.rand((n,), generator=generator, device=device)
  u = torch.rand((), generator=generator, device=device)
  return torch.remainder(
      u + torch.arange(n, dtype=torch.float32, device=device) / n, 1.0)


class VDM(nn.Module):

  def __init__(self, config: ModelConfig):
    super().__init__()
    if config.gamma_type not in SCALAR_SCHEDULES:
      raise ValueError(f'unknown scalar gamma_type: {config.gamma_type!r}')
    self.config = config
    self.encdec = encdec_lib.EncDec(config)
    self.score_model = UNet(config, conditioning_width=1)
    self.gamma = SCALAR_SCHEDULES[config.gamma_type](config)

  @property
  def device(self) -> torch.device:
    return self.score_model.dense0.weight.device

  def _randn(self, shape, generator):
    return torch.randn(shape, generator=generator, device=self.device)

  def _gamma_at(self, t: float) -> torch.Tensor:
    """gamma at one time, a 0-d tensor."""
    return self.gamma(torch.full((1,), t, device=self.device))[0]

  def _conditioning(self, conditioning, batch: int) -> torch.Tensor:
    """The UNet's (B, 1) conditioning column (`conditioning[:, None]`)."""
    if conditioning is None:
      return torch.zeros((batch, 1), device=self.device)
    return torch.as_tensor(conditioning, device=self.device).float().reshape(
        batch, 1)

  def _score(self, z_t, g_t, conditioning, dropout_seed=None):
    """Score UNet on NHWC z_t at gamma g_t (B,); NHWC out."""
    out = self.score_model(z_t.permute(0, 3, 1, 2), g_t, conditioning,
                           dropout_seed)
    return out.permute(0, 2, 3, 1)

  # -- ELBO -------------------------------------------------------------------

  def forward(self, images, *, conditioning=None,
              generator: Optional[torch.Generator] = None,
              deterministic: bool = True, dropout_seed: Optional[int] = None):
    """ELBO at times drawn from `generator` (antithetic or i.i.d., as the
    config says; rounded up to the grid of `sm_n_timesteps` when > 0)."""
    cfg = self.config
    t = sample_times(images.shape[0],
                     antithetic=cfg.antithetic_time_sampling,
                     generator=generator, device=self.device)
    if cfg.sm_n_timesteps > 0:
      t = torch.ceil(t * cfg.sm_n_timesteps) / cfg.sm_n_timesteps
    return self.elbo(images, t, conditioning=conditioning,
                     generator=generator, deterministic=deterministic,
                     dropout_seed=dropout_seed)

  def elbo(self, images, t, *, conditioning=None, eps0=None, eps=None,
           generator: Optional[torch.Generator] = None,
           deterministic: bool = True,
           dropout_seed: Optional[int] = None) -> ELBOOutput:
    """ELBO terms at explicit times t (B,) for uint8 NHWC images.

    eps0, eps: (B, H, W, C) standard normals for the reconstruction and
    diffusion terms. With `deterministic=False` the ResNet blocks drop with
    `sm_pdrop`, their masks keyed by `dropout_seed` (drawn from `generator`
    if None) and the block's site.
    """
    cfg = self.config
    x = torch.as_tensor(images, device=self.device).reshape(
        -1, *cfg.image_shape)
    n = x.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
    if deterministic:
      dropout_seed = None
    elif dropout_seed is None:
      dropout_seed = int(torch.randint(
          2 ** 31 - 1, (), generator=generator,
          device=self.device if generator is None else generator.device))
    T = cfg.sm_n_timesteps

    g_0 = self._gamma_at(0.0)
    g_1 = self._gamma_at(1.0)
    var_0, var_1 = torch.sigmoid(g_0), torch.sigmoid(g_1)
    f = self.encdec.encode(x)

    # 1. reconstruction, z_0 rescaled by 1 / alpha_0.
    if eps0 is None:
      eps0 = self._randn(f.shape, generator)
    z_0_rescaled = f + torch.exp(0.5 * g_0) * eps0
    loss_recon = -self.encdec.logprob(x, z_0_rescaled, g_0)

    # 2. prior KL at t = 1.
    mean1_sqr = (1.0 - var_1) * torch.square(f)
    loss_klz = 0.5 * torch.sum(mean1_sqr + var_1 - torch.log(var_1) - 1.0,
                               dim=(1, 2, 3))

    # 3. diffusion loss.
    g_t, g_t_grad = self.gamma.gamma_and_dgamma(t)
    var_t = torch.sigmoid(g_t)[:, None, None, None]
    if eps is None:
      eps = self._randn(f.shape, generator)
    z_t = torch.sqrt(1.0 - var_t) * f + torch.sqrt(var_t) * eps
    model_output = self._score(z_t, g_t, self._conditioning(conditioning, n),
                               dropout_seed)
    mse = torch.sum(torch.square(eps - model_output), dim=(1, 2, 3))
    if T == 0:
      loss_diff = 0.5 * g_t_grad * mse
    else:
      g_s = self.gamma(t - 1.0 / T)
      weight = torch.expm1(g_t - g_s)
      if cfg.reparam_type == 'input':
        weight = torch.exp(-g_t) * weight
      loss_diff = 0.5 * T * weight * mse

    return ELBOOutput(loss_recon=loss_recon, loss_klz=loss_klz,
                      loss_diff=loss_diff, var_0=var_0, var_1=var_1)

  # -- ancestral sampling -----------------------------------------------------

  def _to_eps_hat(self, model_output, z_t, g_t):
    """The UNet's output as eps-hat: under 'input' it predicts x-hat, and
    eps = (z_t - alpha_t x-hat) / sigma_t."""
    if self.config.reparam_type != 'input':
      return model_output
    var_t = torch.sigmoid(g_t)
    var_t = var_t.reshape(var_t.shape
                          + (1,) * (model_output.dim() - var_t.dim()))
    return (z_t - torch.sqrt(1.0 - var_t) * model_output) / torch.sqrt(var_t)

  def sample(self, i: int, T: int, z_t, *, conditioning=None, eps=None,
             generator: Optional[torch.Generator] = None):
    """One ancestral step from t = (T - i) / T to s = (T - i - 1) / T;
    z_t is NHWC float32."""
    if eps is None:
      eps = self._randn(z_t.shape, generator)
    g_s = self._gamma_at((T - i - 1) / T)
    g_t = self._gamma_at((T - i) / T)
    n = z_t.shape[0]
    model_output = self._score(
        z_t, g_t * torch.ones((n,), device=self.device),
        self._conditioning(conditioning, n))
    eps_hat = self._to_eps_hat(model_output, z_t, g_t)
    a = torch.sigmoid(-g_s)
    b = torch.sigmoid(-g_t)
    c = -torch.expm1(g_s - g_t)
    sigma_t = torch.sqrt(torch.sigmoid(g_t))
    return (torch.sqrt(a / b) * (z_t - sigma_t * c * eps_hat)
            + torch.sqrt((1.0 - a) * c) * eps)

  def conditional_sample(self, i: int, T: int, z_t, embedding, *,
                         conditioning=None, eps=None,
                         generator: Optional[torch.Generator] = None):
    """`sample`, for the harness's API: the VDM has no latent, so the
    embedding is ignored."""
    del embedding
    return self.sample(i, T, z_t, conditioning=conditioning, eps=eps,
                       generator=generator)

  def generate_x(self, z_0, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """z_0 (B, H, W, C) -> pixel values (B, H, W, C) int64: the argmax of
    the decoder's logits, or with `sample_softmax` a categorical draw
    (Gumbel-max, as `jax.random.categorical`)."""
    g_0 = self._gamma_at(0.0)
    z_0_rescaled = z_0 / torch.sqrt(1.0 - torch.sigmoid(g_0))
    logits = self.encdec.decode_logits(z_0_rescaled, g_0)
    if self.config.sample_softmax:
      u = torch.rand(logits.shape, generator=generator, device=self.device)
      logits = logits - torch.log(-torch.log(u))
    return logits.argmax(dim=-1)

  # -- SDE / probability-flow ODE ---------------------------------------------

  def sde(self, xt, t):
    """(drift, diffusion squared) of the forward SDE at t (a scalar or
    (B,)) for NHWC x_t (`mulan_tpu/models/vdm.py:sde`)."""
    t = t * torch.ones((xt.shape[0],), device=self.device)
    g_t, g_t_grad = self.gamma.gamma_and_dgamma(t)
    g_t = g_t[:, None, None, None]
    g_t_grad = g_t_grad[:, None, None, None]
    drift = -0.5 * torch.sigmoid(g_t) * g_t_grad * xt
    return drift, torch.sigmoid(g_t) * g_t_grad

  def reverse_ode(self, xt, embeddings, t, high_precision: bool = False):
    """Probability-flow drift f - g^2 score / 2 for NHWC x_t at t, with
    the UNet conditioned on `embeddings[:, :1]`. `high_precision` has no
    effect (JAX's VDM ignores it). Under 'input' the output is converted to
    eps-hat, as JAX does beside the reference."""
    del high_precision
    t = t * torch.ones((xt.shape[0],), device=self.device)
    drift, diffusion_sqr = self.sde(xt, t)
    g_t = self.gamma(t)
    model_output = self._score(xt, g_t, embeddings[:, :1])
    eps_hat = self._to_eps_hat(model_output, xt, g_t)
    score_hat = -eps_hat / torch.sqrt(torch.sigmoid(g_t))[:, None, None, None]
    return drift - 0.5 * diffusion_sqr * score_hat

  def apply_encoder(self, images) -> torch.Tensor:
    """Zero latent logits (B, latent_size): the VDM has no encoder."""
    n = torch.as_tensor(images).reshape(-1, *self.config.image_shape).shape[0]
    return torch.zeros((n, self.config.latent_size), device=self.device)

  def apply_gamma(self, t) -> torch.Tensor:
    """gamma at t (a number or a 1-d tensor), (B,)."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32,
                                         device=self.device))
    return self.gamma(t)
