"""MuLAN: the ELBO (for evaluation and training), ancestral sampling and
the probability-flow ODE, counterpart of `mulan_tpu/models/mulan.py:MuLAN`
with `parameterization` 'velocity' (the flagship, `cifar10_conditioned`)
or 'epsilon' (`imagenet32`).

Public methods take and return the JAX package's NHWC layout; the networks
run NCHW inside. Noise can be passed in explicitly (`eps0`, `eps`,
`latent_noise`, `dropout_seed`); what is not passed is drawn from
`generator`, which must live on the model's device. With `rows` (a
data-parallel rank's `parallel.mesh.Rows` of the global batch) every draw
is made at the global shape, in the order one process draws it, and cut to
those rows; the dropout masks are the global batch's rows too. A `tensor`
group (`parallel/tensor.py`) splits the score UNet's channels over its
ranks, as JAX's `tensor_mesh` reaches the score model alone: the encoder
and the schedule network stay whole on every rank of the group. Gamma maps
come out of the schedule as (B, n_pixels) in NHWC order and are reshaped
to the NHWC image shape.

Every model variant that JAX builds is built here, from the config:
  * `latent_type` 'topk' (with `topk_noise_type` 'gamma' or 'gumbel'),
    'gumbel' (its temperature annealed by `step`) or 'gaussian' (the
    two-head `UnetEncoderGaussian`, whatever `encoder` says); `encoder`
    'unet' or 'cnn';
  * `reparam_type` other than 'true': no encoder; the embedding is
    one_hot(labels, 10) and the latent KL 0, so the schedule and the score
    UNet are sized for 10 inputs, as JAX's init sizes them (it never calls
    the encoder and creates none of its parameters);
  * `z_conditioning=False`: the score UNet is conditioned on the batch's
    `conditioning` column instead of the embedding;
  * `gamma_type` 'poly_fixedend', 'learnable_nnet' or 'linear'
    (`schedules.py:MULAN_SCHEDULES`);
  * `unet_type` 'vdm' (the UNet sees the mean of the gamma map) or 'ldm'
    (it sees the whole map);
  * `antithetic_time_sampling` and `sample_softmax` (a categorical draw in
    `generate_x`, by Gumbel-max).
As in JAX, the probability-flow methods (`sde`, `score_fn`, `score_jvp`,
`reverse_ode`) hand their `embeddings` to the score UNet as its
conditioning, whatever `z_conditioning` says.

Every parameter is float32; the UNet and the encoder trunk cast theirs to
`config.dtype` at use. Dropout runs only in `forward` / `elbo` with
`deterministic=False`, whatever `self.training` says, as in JAX: the
sampler and the evaluation entry points are always deterministic.

The two parameterizations differ only in how the score UNet's output is
read: the epsilon model predicts the noise, the velocity model predicts
v = alpha eps - sigma x, and with `velocity_from_epsilon` a velocity model's
network predicts the noise, which is reinterpreted as a velocity
(`mulan_tpu/models/mulan.py:123-137`). The epsilon loss takes continuous time
(`sm_n_timesteps` 0) or T discrete steps, with t rounded up to the grid;
the velocity loss is continuous-time only, and raises as JAX asserts.
Both run under each execution-policy flag (`with_attention`, `remat`,
`fused_gn_swish`, `dropout_mask_batch`). `evals/nll_ode.py` solves the
probability-flow ODE of `reverse_ode`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models import encdec as encdec_lib
from mulan_tpu_torch.models import latents
from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.encoder import ENCODERS, UnetEncoderGaussian
from mulan_tpu_torch.models.outputs import ELBOOutput
from mulan_tpu_torch.models.schedules import MULAN_SCHEDULES
from mulan_tpu_torch.models.unet import UNet
from mulan_tpu_torch.models.vdm import sample_times
from mulan_tpu_torch.parallel.mesh import Rows, draw_rows
from mulan_tpu_torch.utils import tracing

PARAMETERIZATIONS = ('epsilon', 'velocity')
# The label classes of the one-hot embedding without an encoder
# (`mulan_tpu/models/mulan.py:174`).
LABEL_CLASSES = 10


def embedding_width(config: ModelConfig) -> int:
  """The width of the latent embedding: `latent_size`, or the label
  classes when `reparam_type` is not 'true'."""
  return config.latent_size if config.reparam_type == 'true' else (
      LABEL_CLASSES)


class MuLAN(nn.Module):

  def __init__(self, config: ModelConfig,
               parameterization: str = 'velocity', tensor=None):
    super().__init__()
    if parameterization not in PARAMETERIZATIONS:
      raise ValueError(f'unknown parameterization: {parameterization!r}')
    if config.unet_type not in ('vdm', 'ldm'):
      raise ValueError(f'unknown unet_type: {config.unet_type!r}')
    if config.gamma_type not in MULAN_SCHEDULES:
      raise ValueError(f'unknown gamma_type: {config.gamma_type!r}')
    self.config = config
    self.parameterization = parameterization
    self.encdec = encdec_lib.EncDec(config)
    width = embedding_width(config)
    self.score_model = UNet(
        config, conditioning_width=width if config.z_conditioning else 1,
        per_pixel_gamma=config.unet_type == 'ldm', tensor=tensor)
    if config.latent_type == 'gaussian':
      encoder = UnetEncoderGaussian
    elif config.latent_type in ('topk', 'gumbel'):
      encoder = ENCODERS[config.encoder]
    else:
      raise ValueError(f'unknown latent_type: {config.latent_type!r}')
    self.encoder_model = (encoder(config) if config.reparam_type == 'true'
                          else None)
    self.gamma = MULAN_SCHEDULES[config.gamma_type](config, width)

  @property
  def device(self) -> torch.device:
    return self.score_model.dense0.weight.device

  def _randn(self, shape, generator):
    return torch.randn(shape, generator=generator, device=self.device)

  def _noise(self, shape, generator, rows: Optional[Rows] = None):
    """Standard normals of `shape` (`rows` of the global batch's draw)."""
    return draw_rows(lambda s: self._randn(s, generator), shape, rows)

  def _score(self, z_t, g_t, conditioning, dropout_seed=None,
             dropout_row: int = 0):
    """Score UNet on NHWC z_t, conditioned on the gamma map g_t (its mean
    for the 'vdm' UNet, `mulan.py:_score_gt`); NHWC out."""
    if self.config.unet_type == 'vdm':
      g_t = g_t.mean(dim=(1, 2, 3))
    out = self.score_model(z_t.permute(0, 3, 1, 2), g_t, conditioning,
                           dropout_seed, dropout_row)
    return out.permute(0, 2, 3, 1)

  def _conditioning(self, conditioning, embedding) -> torch.Tensor:
    """The score UNet's conditioning in the ELBO and the ancestral sampler:
    the embedding, or without `z_conditioning` the batch's conditioning
    column (zeros when None)."""
    if self.config.z_conditioning:
      return embedding
    if conditioning is None:
      return torch.zeros((embedding.shape[0], 1), device=self.device)
    return torch.as_tensor(conditioning, device=self.device).float().reshape(
        -1, 1)

  def _velocity(self, model_out, g_t, z_t):
    """The velocity model's v-hat: the output itself, or with
    `velocity_from_epsilon` the network's eps-hat reinterpreted as
    -exp(g/2) z_t + sqrt(1 + exp(g)) eps-hat."""
    if not self.config.velocity_from_epsilon:
      return model_out
    return (-torch.exp(0.5 * g_t) * z_t
            + torch.sqrt(1 + torch.exp(g_t)) * model_out)

  def _to_eps_hat(self, model_out, g_t, z_t):
    """The model's output as eps-hat = alpha v-hat + sigma z_t (the
    epsilon model's output is eps-hat)."""
    if self.parameterization == 'epsilon':
      return model_out
    v_hat = self._velocity(model_out, g_t, z_t)
    return (v_hat * torch.sqrt(torch.sigmoid(-g_t))
            + torch.sqrt(torch.sigmoid(g_t)) * z_t)

  def _score_of(self, model_out, g_t, z_t):
    """The score -eps-hat / sigma of the model's output, in the form JAX
    writes for each parameterization (`mulan_tpu/models/mulan.py:287-297`)."""
    if self.parameterization == 'epsilon':
      return -model_out / torch.sqrt(torch.sigmoid(g_t))
    if self.config.velocity_from_epsilon:
      return -model_out * torch.sqrt(1 + torch.exp(-g_t))
    return -z_t - torch.exp(-0.5 * g_t) * model_out

  # -- ELBO -------------------------------------------------------------------

  def forward(self, images, t=None, *, labels=None, conditioning=None,
              step=0, generator: Optional[torch.Generator] = None,
              deterministic: bool = True, dropout_seed: Optional[int] = None,
              rows: Optional[Rows] = None, **noise):
    """ELBO at times `t`, or at times drawn from `generator` (antithetic or
    i.i.d., as the config says), rounded up to the grid of
    `sm_n_timesteps` when that is > 0; `noise` and the other arguments as
    `elbo`'s. Data-parallel wrappers call the model through here."""
    cfg = self.config
    if t is None:
      t = sample_times(torch.as_tensor(images).shape[0],
                       antithetic=cfg.antithetic_time_sampling,
                       generator=generator, device=self.device, rows=rows)
      T = cfg.sm_n_timesteps
      if T > 0:
        t = torch.ceil(t * T) / T
    return self.elbo(images, t, labels=labels, conditioning=conditioning,
                     step=step, generator=generator,
                     deterministic=deterministic, dropout_seed=dropout_seed,
                     rows=rows, **noise)

  def _encoder(self, f, dropout_seed=None, dropout_row: int = 0):
    """The encoder on NHWC features f in [-1, 1]: logits (B, latent_size),
    or (mu, var) for the Gaussian latent."""
    if self.encoder_model is None:
      raise ValueError(
          f'reparam_type={self.config.reparam_type!r}: the model has no '
          'latent encoder (JAX never creates its parameters, and flax raises '
          'ScopeParamNotFoundError when it is called, mulan_tpu/models/'
          'mulan.py:66)')
    return self.encoder_model(f.permute(0, 3, 1, 2), dropout_seed,
                              dropout_row)

  def apply_encoder(self, images):
    """uint8 NHWC images -> the encoder's output without dropout: the latent
    logits (B, latent_size), or (mu, var) for the Gaussian latent
    (`mulan_tpu/models/mulan.py:apply_encoder`)."""
    x = torch.as_tensor(images, device=self.device).reshape(
        -1, *self.config.image_shape)
    return self._encoder(self.encdec.encode(x))

  def _embedding_and_kl(self, f, step, dropout_seed=None,
                        encoder_logits=None, latent_noise=None,
                        generator=None, rows: Optional[Rows] = None):
    """(embedding, latent KL) of NHWC features f (`mulan.py:69-89`), f
    being `rows` of the global batch."""
    cfg = self.config
    if encoder_logits is not None:
      if cfg.latent_type not in ('topk', 'gumbel'):
        raise ValueError('encoder_logits stand in for a logits encoder, not '
                         f'latent_type={cfg.latent_type!r}')
      heads = torch.as_tensor(encoder_logits, device=self.device)
    else:
      heads = self._encoder(f, dropout_seed,
                            0 if rows is None else rows.start)
    if latent_noise is None:
      latent_noise = latents.latent_variates(cfg, f.shape[0],
                                             generator=generator,
                                             device=self.device, rows=rows)
    return latents.embedding_and_kl(cfg, heads, latent_noise, step)

  def elbo(self, images, t, *, labels=None, conditioning=None, step=0,
           eps0=None, eps=None, latent_noise=None, encoder_logits=None,
           generator: Optional[torch.Generator] = None,
           deterministic: bool = True,
           dropout_seed: Optional[int] = None,
           rows: Optional[Rows] = None) -> ELBOOutput:
    """ELBO terms at explicit times t (B,) for uint8 NHWC images.

    labels (B,) give the one-hot embedding when `reparam_type` is not
    'true'; conditioning (B,) is the score UNet's input without
    `z_conditioning` (zeros when None); `step` anneals the Gumbel latent's
    temperature. eps0, eps: (B, H, W, C) standard normals for the
    reconstruction and diffusion terms. latent_noise: the latent's draw
    (`latents.latent_variates`): Gamma(1/latent_k) variates
    (latents.N_GAMMA_TERMS, B, latent_size) for the top-k with Gamma noise,
    standard Gumbels (B, latent_size) for the top-k with Gumbel noise and
    the Gumbel latent, standard normals (B, latent_size) for the Gaussian.
    With `deterministic=False` the ResNet blocks drop with `sm_pdrop`, their
    masks keyed by `dropout_seed` (drawn from `generator` if None) and the
    block's site. `encoder_logits` (B, latent_size), if given, stand in for
    the encoder (the dense VLB computes them once per image and repeats
    them over its t-grid); the latent's noise is still drawn for every row.
    The velocity loss is continuous-time only: with `sm_n_timesteps` > 0
    it raises AssertionError, as JAX's assertion does. With `rows` the
    images are those rows of the global batch: what is drawn here, and the
    dropout masks, are the global batch's, cut to them. Runs in the span
    'elbo', its parts in 'latent', 'schedule', 'decoder' and 'score'
    (`utils/tracing.py`).
    """
    with tracing.span('elbo'):
      cfg = self.config
      T = cfg.sm_n_timesteps
      if self.parameterization == 'velocity' and T > 0:
        raise AssertionError('velocity parameterization is continuous-time '
                             'only')
      x = torch.as_tensor(images, device=self.device).reshape(
          -1, *cfg.image_shape)
      img = x.shape
      t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
      if deterministic:
        dropout_seed = None
      elif dropout_seed is None:
        dropout_seed = int(torch.randint(
            2 ** 31 - 1, (), generator=generator,
            device=self.device if generator is None else generator.device))

      with tracing.span('latent'):
        orig_f = self.encdec.encode(x)
        if cfg.reparam_type == 'true':
          embedding, kl_z = self._embedding_and_kl(
              orig_f, step, dropout_seed, encoder_logits, latent_noise,
              generator, rows)
        else:
          if labels is None:
            raise ValueError(f'reparam_type={cfg.reparam_type!r} embeds the '
                             'labels: pass labels')
          embedding = F.one_hot(
              torch.as_tensor(labels, device=self.device).long(),
              LABEL_CLASSES).float()
          kl_z = 0.0

      with tracing.span('schedule'):
        g_0, g_1, g_t, g_t_grad = (
            g.reshape(img) for g in self.gamma.elbo_gammas(embedding, t))
      var_t = torch.sigmoid(g_t)
      var_0 = torch.sigmoid(g_0)
      var_1 = torch.sigmoid(g_1)

      # 1. reconstruction.
      if eps0 is None:
        eps0 = self._noise(img, generator, rows)
      z_0_rescaled = orig_f + torch.exp(0.5 * g_0) * eps0
      with tracing.span('decoder'):
        loss_recon = -self.encdec.logprob(x, z_0_rescaled, g_0)

      # 2. prior KL at t = 1.
      mean1_sqr = (1.0 - var_1) * torch.square(orig_f)
      loss_klz = 0.5 * torch.sum(mean1_sqr + var_1 - torch.log(var_1) - 1.0,
                                 dim=(1, 2, 3))

      # 3. diffusion loss.
      if eps is None:
        eps = self._noise(img, generator, rows)
      z_t = torch.sqrt(1.0 - var_t) * orig_f + torch.sqrt(var_t) * eps
      with tracing.span('score'):
        model_out = self._score(z_t, g_t,
                                self._conditioning(conditioning, embedding),
                                dropout_seed, 0 if rows is None else rows.start)
      if self.parameterization == 'epsilon':
        if T == 0:
          weight = g_t_grad
        else:
          g_s = self.gamma(embedding, t - 1.0 / T).reshape(img)
          weight = T * torch.expm1(g_t - g_s)
        loss_diff = 0.5 * torch.sum(weight * torch.square(eps - model_out),
                                    dim=(1, 2, 3))
      else:
        v_hat = self._velocity(model_out, g_t, z_t)
        v_target = torch.sqrt(1.0 - var_t) * eps - torch.sqrt(var_t) * orig_f
        loss_diff = 0.5 * torch.sum(
            (1 - var_t) * g_t_grad * torch.square(v_target - v_hat),
            dim=(1, 2, 3))

      return ELBOOutput(loss_recon=loss_recon, loss_klz=kl_z + loss_klz,
                        loss_diff=loss_diff, var_0=var_0.mean(),
                        var_1=var_1.mean())

  def gamma_of(self, embedding, t):
    """gamma(z, t): embedding (B, width) and t (B,) -> (B, n_pixels)
    (`mulan_tpu/models/mulan.py:gamma_of`)."""
    return self.gamma(embedding, t)

  def gamma_and_dgamma(self, embedding, t):
    """(gamma, dgamma/dt), each (B, n_pixels)."""
    return self.gamma.gamma_and_dgamma(embedding, t)

  def apply_gamma(self, t, x_zero=None, *, step=0, latent_noise=None,
                  dropout_seed: Optional[int] = None,
                  generator: Optional[torch.Generator] = None):
    """gamma (B, n_pixels) at t (a number or (B,)), conditioned on the
    latent of the uint8 NHWC images `x_zero` (drawn as in `elbo`; with a
    `dropout_seed` the encoder drops, as JAX's default
    `deterministic=False` does), or on a zero embedding
    (`mulan_tpu/models/mulan.py:98-107`)."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32,
                                         device=self.device))
    if x_zero is None:
      embedding = torch.zeros((t.shape[0], self.config.latent_size),
                              device=self.device)
    else:
      x = torch.as_tensor(x_zero, device=self.device).reshape(
          -1, *self.config.image_shape)
      embedding, _ = self._embedding_and_kl(
          self.encdec.encode(x), step, dropout_seed,
          latent_noise=latent_noise, generator=generator)
    return self.gamma(embedding, t)

  # -- ancestral sampling -----------------------------------------------------

  def deterministic_embedding(self, batch_size: int) -> torch.Tensor:
    """The canonical embedding of `latent_type` (`latents.py:87-99`)."""
    cfg = self.config
    return latents.deterministic_embedding(batch_size, cfg.latent_size,
                                           cfg.latent_k, cfg.latent_type,
                                           device=self.device)

  def conditional_sample(self, i: int, T: int, z_t, embedding, *,
                         conditioning=None, eps=None,
                         generator: Optional[torch.Generator] = None,
                         rows: Optional[Rows] = None):
    """One ancestral step from t = (T - i) / T to s = (T - i - 1) / T given a
    fixed latent embedding; z_t is NHWC float32 (`rows` of the global
    batch), `conditioning` (B,) the UNet's input without `z_conditioning`
    (zeros when None)."""
    if eps is None:
      eps = self._noise(z_t.shape, generator, rows)
    bsz = z_t.shape[0]
    t = torch.full((bsz,), (T - i) / T, device=self.device)
    s = torch.full((bsz,), (T - i - 1) / T, device=self.device)
    g_t = self.gamma(embedding, t).reshape(z_t.shape)
    g_s = self.gamma(embedding, s).reshape(z_t.shape)
    model_out = self._score(z_t, g_t,
                            self._conditioning(conditioning, embedding))
    eps_hat = self._to_eps_hat(model_out, g_t, z_t)

    a = torch.sigmoid(-g_s)
    b = torch.sigmoid(-g_t)
    c = -torch.expm1(g_s - g_t)
    sigma_t = torch.sqrt(torch.sigmoid(g_t))
    z_s_mean = torch.sqrt(a / b) * (z_t - sigma_t * c * eps_hat)
    return z_s_mean + torch.sqrt((1.0 - a) * c) * eps

  def sample(self, i: int, T: int, z_t, *, conditioning=None, eps=None,
             generator: Optional[torch.Generator] = None,
             rows: Optional[Rows] = None):
    """One unconditional ancestral step: `conditional_sample` with the
    canonical `deterministic_embedding`."""
    return self.conditional_sample(
        i, T, z_t, self.deterministic_embedding(z_t.shape[0]),
        conditioning=conditioning, eps=eps, generator=generator, rows=rows)

  def generate_x(self, z_0, generator: Optional[torch.Generator] = None, *,
                 gumbel=None, rows: Optional[Rows] = None) -> torch.Tensor:
    """z_0 (B, H, W, C) -> pixel values (B, H, W, C) int64: the argmax of
    the decoder's logits, or with `sample_softmax` a categorical draw by
    Gumbel-max, the argmax of logits + `gumbel` (standard Gumbels shaped
    like the logits, (B, H, W, C, vocab_size), drawn from `generator` when
    None), as `jax.random.categorical` draws it."""
    bsz = z_0.shape[0]
    g_0 = self.gamma(self.deterministic_embedding(bsz),
                     torch.zeros((bsz,), device=self.device)).reshape(
                         z_0.shape)
    z_0_rescaled = z_0 / torch.sqrt(1.0 - torch.sigmoid(g_0))
    logits = self.encdec.decode_logits(z_0_rescaled, g_0)
    if self.config.sample_softmax:
      if gumbel is None:
        gumbel = latents.gumbel_variates(logits.shape, generator=generator,
                                         device=self.device, rows=rows)
      logits = logits + torch.as_tensor(gumbel, device=self.device)
    return logits.argmax(dim=-1)

  # -- SDE / probability-flow ODE ---------------------------------------------

  def _gammas(self, embeddings, t, shape):
    """gamma(z, t) and dgamma/dt at t (a scalar or (B,)), in `shape`."""
    t = t * torch.ones((shape[0],), device=self.device)
    return (g.reshape(shape) for g in
            self.gamma.gamma_and_dgamma(embeddings, t))

  def sde(self, xt, embeddings, t):
    """(drift, diffusion) of the forward SDE at t for NHWC x_t
    (`mulan_tpu/models/mulan.py:sde`)."""
    g_t, g_t_grad = self._gammas(embeddings, t, xt.shape)
    drift = -0.5 * torch.sigmoid(g_t) * g_t_grad * xt
    diffusion = torch.sqrt(torch.sigmoid(g_t) * g_t_grad)
    return drift, diffusion

  def score_fn(self, xt, gt, embeddings):
    """The score of NHWC x_t at the gamma map gt: -eps-hat / sigma
    (epsilon), -x_t - exp(-gamma/2) v-hat (velocity), -eps-hat
    sqrt(1 + exp(-gamma)) (`velocity_from_epsilon`)."""
    return self._score_of(self._score(xt, gt, embeddings), gt, xt)

  def score_jvp(self, z_t, g_t, conditioning, v,
                dropout_seed: Optional[int] = None):
    """(score, its JVP along v with respect to z_t) by forward-mode AD
    (`torch.func.jvp`); `dropout_seed` None is the deterministic pass.

    The CUDA kernels are opaque to forward-mode AD (a kernel called on a
    dual tensor would return the primal and drop the tangent), so with
    `use_kernels` on a CUDA device this raises, as JAX's custom_vjp kernels
    refuse forward mode.
    """
    if self.config.use_kernels and self.device.type == 'cuda':
      raise NotImplementedError(
          'score_jvp needs forward-mode AD, which the CUDA kernels do not '
          'have; build the model with use_kernels=False')

    def score(xt):
      return self._score_of(
          self._score(xt, g_t, conditioning, dropout_seed), g_t, xt)
    return torch.func.jvp(score, (z_t,), (v,))

  def reverse_ode(self, xt, embeddings, t, high_precision: bool = False):
    """Probability-flow drift dx/dt for NHWC x_t at t (a scalar or (B,)):
    0.5 (-sigma x_t + eps-hat) sigma dgamma/dt for the epsilon model,
    0.5 alpha sigma dgamma/dt v-hat for the velocity model.

    `high_precision` takes sigma = exp(gamma/2) where sigma^2 <= 1e-3 and
    alpha = exp(-gamma/2) where alpha^2 <= 1e-3, the log-domain forms, in
    place of sqrt(sigmoid(+-gamma)) (`mulan_tpu/models/mulan.py:331-338`).
    """
    g_t, g_t_grad = self._gammas(embeddings, t, xt.shape)
    model_out = self._score(xt, g_t, embeddings)
    var = torch.sigmoid(g_t)
    if high_precision:
      sigma = torch.where(var <= 1e-3, torch.exp(g_t / 2), torch.sqrt(var))
      alpha = torch.where(1 - var <= 1e-3, torch.exp(-g_t / 2),
                          torch.sqrt(1 - var))
    else:
      sigma = torch.sqrt(var)
      alpha = torch.sqrt(1 - var)
    if self.parameterization == 'epsilon':
      return 0.5 * (-sigma * xt + model_out) * sigma * g_t_grad
    v_hat = self._velocity(model_out, g_t, xt)
    return v_hat * 0.5 * alpha * sigma * g_t_grad
