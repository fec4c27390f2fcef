"""MuLAN in plain float32 PyTorch: the ELBO of the velocity and epsilon
parameterizations, its parameters' shapes, and the noise a train step or a
dense-VLB chunk draws.

This is the benchmark's yardstick. It imports nothing of the program under
test: it is written from the model's equations (MuLAN, arXiv:2312.13236;
the VDM UNet of Kingma et al. 2021), over a flat dict of parameters named
as the program's state dict names them, in float32 with TF32 off.

The model: images x (B, H, W, C) uint8 are mapped to f in (-1, 1). A latent
encoder (a UNet trunk at full resolution with one attention block, a
1-channel head and a dense layer) gives `latent_size` logits; a smoothed
top-k of the logits perturbed by Gamma noise is the embedding. A per-pixel
noise schedule gamma(z, t) = gmin + (gmax - gmin) P(t) / P(1), P the
integral of (a u^2 + b u + c)^2 with (a, b, c) from an MLP on the
embedding. The score UNet (no down-sampling: n ResNet blocks, a
ResNet-attention-ResNet middle, n + 1 up blocks over the skips) sees z_t
and the mean of gamma_t and the embedding, and predicts the velocity
(or the noise). The ELBO is the decoder's reconstruction term at t = 0,
the prior KL at t = 1 plus the latent's KL, and the diffusion loss at t.

`Numerics` sets the precision of every product (convolutions, dense
layers, the attention's two products): float32, or the operands rounded
to bfloat16 or to float8 (e4m3, one scale a tensor) with the gradients
flowing back rounded the same way. The lower precisions are the controls
that the comparison must reject.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import philox

LN2 = math.log(2.0)
N_GAMMA_TERMS = 10
GAMMA_TAU = 10.0
FOURIER_EXPONENTS = (6, 7)
# The layers whose fresh values the benchmark draws from N(0, 0.02): they
# would otherwise start at zero and hide the kernels behind them.
ZERO_INIT = ('cond_proj', 'conv2', 'proj_out', 'conv_out', 'dense_out_a')
E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Model:
  """What the reference needs of a configuration."""
  parameterization: str  # 'velocity' | 'epsilon'
  image_size: int = 32
  channels: int = 3
  vocab_size: int = 256
  n_embd: int = 128
  n_layer: int = 32
  encoder_layers: int = 4
  latent_size: int = 50
  latent_k: int = 15
  pdrop: float = 0.1
  gamma_min: float = -13.3
  gamma_max: float = 5.0

  @property
  def n_pixels(self) -> int:
    return self.image_size * self.image_size * self.channels

  @property
  def unet_sites(self) -> int:
    return 2 * self.n_layer + 3

  @classmethod
  def from_config(cls, model: dict, vdm_type: str) -> 'Model':
    """From the program's model config fields (a dict) and its vdm_type."""
    supported = dict(gamma_type='poly_fixedend', unet_type='vdm',
                     with_fourier_features=True, with_attention=False,
                     encoder='unet', latent_type='topk',
                     topk_noise_type='gamma', reparam_type='true',
                     z_conditioning=True, velocity_from_epsilon=False,
                     antithetic_time_sampling=True, sm_n_timesteps=0)
    for key, want in supported.items():
      if model.get(key, want) != want:
        raise ValueError(f'the reference models {key}={want!r}, the '
                         f'configuration has {model[key]!r}')
    par = {'mulan_velocity': 'velocity', 'mulan_epsilon': 'epsilon'}
    if vdm_type not in par:
      raise ValueError(f'the reference has no vdm_type {vdm_type!r}')
    return cls(parameterization=par[vdm_type],
               image_size=model['image_size'],
               channels=model['image_channels'],
               vocab_size=model['vocab_size'], n_embd=model['sm_n_embd'],
               n_layer=model['sm_n_layer'],
               encoder_layers=model['forward_n_layer'],
               latent_size=model['latent_size'], latent_k=model['latent_k'],
               pdrop=model['sm_pdrop'], gamma_min=model['gamma_min'],
               gamma_max=model['gamma_max'])


# -- parameters --------------------------------------------------------------


def _resnet_shapes(prefix, c_in, c_out, cond):
  out = {f'{prefix}.GroupNormF32_0.weight': (c_in,),
         f'{prefix}.GroupNormF32_0.bias': (c_in,),
         f'{prefix}.conv1.weight': (c_out, c_in, 3, 3),
         f'{prefix}.conv1.bias': (c_out,),
         f'{prefix}.cond_proj.weight': (c_out, cond),
         f'{prefix}.GroupNormF32_1.weight': (c_out,),
         f'{prefix}.GroupNormF32_1.bias': (c_out,),
         f'{prefix}.conv2.weight': (c_out, c_out, 3, 3),
         f'{prefix}.conv2.bias': (c_out,)}
  if c_in != c_out:
    out[f'{prefix}.nin_shortcut.weight'] = (c_out, c_in, 1, 1)
    out[f'{prefix}.nin_shortcut.bias'] = (c_out,)
  return out


def _attn_shapes(prefix, c):
  out = {f'{prefix}.GroupNormF32_0.weight': (c,),
         f'{prefix}.GroupNormF32_0.bias': (c,)}
  for name in ('q', 'k', 'v', 'proj_out'):
    out[f'{prefix}.{name}.weight'] = (c, c)
    out[f'{prefix}.{name}.bias'] = (c,)
  return out


def param_shapes(m: Model) -> Dict[str, tuple]:
  """Every parameter's name and shape, as the program's state dict has
  them (convolutions OIHW, dense layers (out, in))."""
  c, cond = m.n_embd, 4 * m.n_embd
  c_in = m.channels * (1 + 2 * len(FOURIER_EXPONENTS))
  s = {'score_model.dense0.weight': (cond, c + m.latent_size),
       'score_model.dense0.bias': (cond,),
       'score_model.dense1.weight': (cond, cond),
       'score_model.dense1.bias': (cond,),
       'score_model.conv_in.weight': (c, c_in, 3, 3),
       'score_model.conv_in.bias': (c,)}
  for i in range(m.n_layer):
    s.update(_resnet_shapes(f'score_model.down_block_{i}', c, c, cond))
  s.update(_resnet_shapes('score_model.mid_block_1', c, c, cond))
  s.update(_attn_shapes('score_model.mid_attn_1', c))
  s.update(_resnet_shapes('score_model.mid_block_2', c, c, cond))
  for i in range(m.n_layer + 1):
    s.update(_resnet_shapes(f'score_model.up_block_{i}', 2 * c, c, cond))
  s.update({'score_model.GroupNormF32_0.weight': (c,),
            'score_model.GroupNormF32_0.bias': (c,),
            'score_model.conv_out.weight': (m.channels, c, 3, 3),
            'score_model.conv_out.bias': (m.channels,)})
  t = 'encoder_model.trunk'
  s.update({f'{t}.dense0.weight': (cond, c + 1), f'{t}.dense0.bias': (cond,),
            f'{t}.dense1.weight': (cond, cond), f'{t}.dense1.bias': (cond,),
            f'{t}.conv_in.weight': (c, c_in, 3, 3), f'{t}.conv_in.bias': (c,)})
  for i in range(m.encoder_layers):
    s.update(_resnet_shapes(f'{t}.down_block_{i}', c, c, cond))
  s.update(_resnet_shapes(f'{t}.mid_block_1', c, c, cond))
  s.update(_attn_shapes(f'{t}.mid_attn_1', c))
  s.update(_resnet_shapes(f'{t}.mid_block_2', c, c, cond))
  hw = m.image_size ** 2
  s.update({f'{t}.GroupNormF32_0.weight': (c,), f'{t}.GroupNormF32_0.bias': (c,),
            f'{t}.conv_out.weight': (1, c, 3, 3), f'{t}.conv_out.bias': (1,),
            'encoder_model.dense_layer_final.weight': (m.latent_size, hw),
            'encoder_model.dense_layer_final.bias': (m.latent_size,)})
  n = m.n_pixels
  s.update({'gamma.dense_1.weight': (n, m.latent_size),
            'gamma.dense_1.bias': (n,)})
  for name in ('dense_2', 'dense_out_a', 'dense_out_b', 'dense_out_c'):
    s[f'gamma.{name}.weight'] = (n, n)
    s[f'gamma.{name}.bias'] = (n,)
  return s


def init_scale(name: str, shape) -> Optional[float]:
  """The standard deviation of a fresh leaf, or None for a unit GroupNorm
  scale: N(0, 1 / fan_in) for weights, N(0, 0.02) for biases, GroupNorm
  offsets and the layers that would start at zero."""
  module, leaf = name.rsplit('.', 1)
  if 'GroupNormF32' in module and leaf == 'weight':
    return None
  if leaf == 'bias' or module.rsplit('.', 1)[-1] in ZERO_INIT:
    return 0.02
  return 1.0 / math.sqrt(math.prod(shape[1:]))


@torch.no_grad()
def make_weights(m: Model, seed: int, device) -> Dict[str, torch.Tensor]:
  """Seeded float32 weights on `device`, from one normal draw of every
  element at once on a generator of that device."""
  shapes = param_shapes(m)
  gen = torch.Generator(device).manual_seed(seed % (2 ** 63))
  total = sum(math.prod(s) for s in shapes.values())
  flat = torch.randn(total, generator=gen, device=device)
  out, at = {}, 0
  for name in sorted(shapes):
    shape = shapes[name]
    n = math.prod(shape)
    scale = init_scale(name, shape)
    value = flat[at:at + n].view(shape)
    at += n
    out[name] = (torch.ones(shape, device=device) if scale is None
                 else value.mul_(scale))
  return out


# -- numerics ------------------------------------------------------------------


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
  if mode == 'bfloat16':
    return x.to(torch.bfloat16).float()
  amax = x.detach().abs().amax().clamp_min(1e-30)
  scale = E4M3_MAX / amax
  return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _RoundOperand(torch.autograd.Function):
  """Rounds in the forward; the gradient passes through."""

  @staticmethod
  def forward(ctx, x, mode):
    return _round(x, mode)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _RoundGradient(torch.autograd.Function):
  """The identity in the forward; rounds the gradient in the backward."""

  @staticmethod
  def forward(ctx, x, mode):
    ctx.mode = mode
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _round(g, ctx.mode), None


@dataclasses.dataclass(frozen=True)
class Numerics:
  """The precision of the products: 'float32', 'bfloat16' or 'fp8'."""
  mode: str = 'float32'

  def operand(self, x):
    return x if self.mode == 'float32' else _RoundOperand.apply(x, self.mode)

  def output(self, y):
    return y if self.mode == 'float32' else _RoundGradient.apply(y, self.mode)

  def conv(self, x, w, b, padding):
    return self.output(F.conv2d(self.operand(x), self.operand(w), b,
                                padding=padding))

  def dense(self, x, w, b=None):
    return self.output(F.linear(self.operand(x), self.operand(w), b))

  def bmm(self, a, b):
    return self.output(torch.matmul(self.operand(a), self.operand(b)))


FLOAT32 = Numerics()


# -- layers ------------------------------------------------------------------


def timestep_embedding(t, dim):
  t = t.float() * 1000.0
  half = dim // 2
  freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                    * (-math.log(10000.0) / (half - 1)))
  args = t[:, None] * freqs[None, :]
  return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def fourier_features(x):
  """x (B, C, H, W) -> cat(x, sin(h), cos(h)), h = x_c 2^k 2 pi for each
  channel c and k in FOURIER_EXPONENTS, channel-major."""
  w = torch.tensor([2.0 ** k * 2 * math.pi for k in FOURIER_EXPONENTS],
                   device=x.device)
  h = (x[:, :, None] * w[None, None, :, None, None]).flatten(1, 2)
  return torch.cat([x, torch.sin(h), torch.cos(h)], dim=1)


def group_norm(p, prefix, x):
  c = x.shape[1]
  return F.group_norm(x, math.gcd(c, 32), p[f'{prefix}.weight'],
                      p[f'{prefix}.bias'], 1e-6)


def resnet_block(p, prefix, x, cond, num: Numerics, mask=None):
  h = F.silu(group_norm(p, f'{prefix}.GroupNormF32_0', x))
  h = num.conv(h, p[f'{prefix}.conv1.weight'], p[f'{prefix}.conv1.bias'], 1)
  h = h + num.dense(cond, p[f'{prefix}.cond_proj.weight'])[:, :, None, None]
  h = F.silu(group_norm(p, f'{prefix}.GroupNormF32_1', h))
  if mask is not None:
    h = h * mask
  h = num.conv(h, p[f'{prefix}.conv2.weight'], p[f'{prefix}.conv2.bias'], 1)
  if f'{prefix}.nin_shortcut.weight' in p:
    x = num.conv(x, p[f'{prefix}.nin_shortcut.weight'],
                 p[f'{prefix}.nin_shortcut.bias'], 0)
  return x + h


def attn_block(p, prefix, x, num: Numerics):
  b, c, hgt, wid = x.shape
  tokens = group_norm(p, f'{prefix}.GroupNormF32_0', x).flatten(2)
  tokens = tokens.transpose(1, 2)
  q, k, v = (num.dense(tokens, p[f'{prefix}.{n}.weight'],
                       p[f'{prefix}.{n}.bias']) for n in 'qkv')
  att = torch.softmax(num.bmm(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
  out = num.dense(num.bmm(att, v), p[f'{prefix}.proj_out.weight'],
                  p[f'{prefix}.proj_out.bias'])
  return x + out.transpose(1, 2).reshape(b, c, hgt, wid)


class Dropout:
  """The masks of one pass: keyed by `seed` and each block's site, the
  rows [first_row, first_row + rows) of the global batch."""

  def __init__(self, seed: int, rate: float, first_row: int = 0):
    self.seed, self.rate, self.first_row = seed, rate, first_row

  def mask(self, site: int, shape, device):
    if self.rate <= 0:
      return None
    per_row = math.prod(shape[1:])
    return philox.keep_mask(self.seed, site, shape, self.rate, device,
                            self.first_row * per_row)


def _masked_block(p, prefix, h, cond, num, drop, site):
  """A ResNet block with its dropout mask, drawn at the shape of the
  block's second activation, (B, n_embd, H, W)."""
  shape = (h.shape[0], p[f'{prefix}.conv2.weight'].shape[0], *h.shape[2:])
  mask = None if drop is None else drop.mask(site, shape, h.device)
  return resnet_block(p, prefix, h, cond, num, mask)


def score_unet(p, m: Model, z, g_mean, emb, num: Numerics, drop=None):
  """z (B, C, H, W), g_mean (B,), emb (B, latent_size) -> (B, C, H, W)."""
  t = (g_mean - m.gamma_min) / (m.gamma_max - m.gamma_min)
  cond = torch.cat([timestep_embedding(t, m.n_embd), emb], dim=-1)
  cond = F.silu(num.dense(cond, p['score_model.dense0.weight'],
                          p['score_model.dense0.bias']))
  cond = F.silu(num.dense(cond, p['score_model.dense1.weight'],
                          p['score_model.dense1.bias']))
  hs = [num.conv(fourier_features(z), p['score_model.conv_in.weight'],
                 p['score_model.conv_in.bias'], 1)]
  site = 0
  for i in range(m.n_layer):
    hs.append(_masked_block(p, f'score_model.down_block_{i}', hs[-1], cond,
                            num, drop, site))
    site += 1
  h = _masked_block(p, 'score_model.mid_block_1', hs[-1], cond, num, drop,
                    site)
  h = attn_block(p, 'score_model.mid_attn_1', h, num)
  h = _masked_block(p, 'score_model.mid_block_2', h, cond, num, drop,
                    site + 1)
  site += 2
  for i in range(m.n_layer + 1):
    h = _masked_block(p, f'score_model.up_block_{i}',
                      torch.cat([h, hs.pop()], dim=1), cond, num, drop, site)
    site += 1
  h = F.silu(group_norm(p, 'score_model.GroupNormF32_0', h))
  return num.conv(h, p['score_model.conv_out.weight'],
                  p['score_model.conv_out.bias'], 1) + z


def encoder_logits(p, m: Model, f, num: Numerics, drop=None):
  """f (B, C, H, W) in (-1, 1) -> latent logits (B, latent_size)."""
  t = 'encoder_model.trunk'
  b = f.shape[0]
  zero = torch.zeros((b,), device=f.device)
  cond = torch.cat([timestep_embedding(zero, m.n_embd), zero[:, None]], 1)
  cond = F.silu(num.dense(cond, p[f'{t}.dense0.weight'],
                          p[f'{t}.dense0.bias']))
  cond = F.silu(num.dense(cond, p[f'{t}.dense1.weight'],
                          p[f'{t}.dense1.bias']))
  h = num.conv(fourier_features(f), p[f'{t}.conv_in.weight'],
               p[f'{t}.conv_in.bias'], 1)
  site = m.unet_sites
  for i in range(m.encoder_layers):
    h = _masked_block(p, f'{t}.down_block_{i}', h, cond, num, drop, site)
    site += 1
  h = _masked_block(p, f'{t}.mid_block_1', h, cond, num, drop, site)
  h = attn_block(p, f'{t}.mid_attn_1', h, num)
  h = _masked_block(p, f'{t}.mid_block_2', h, cond, num, drop, site + 1)
  h = F.silu(group_norm(p, f'{t}.GroupNormF32_0', h))
  h = num.conv(h, p[f'{t}.conv_out.weight'], p[f'{t}.conv_out.bias'], 1)
  h = F.silu(h.reshape(b, -1))
  return num.dense(h, p['encoder_model.dense_layer_final.weight'],
                   p['encoder_model.dense_layer_final.bias'])


def topk_embedding(m: Model, logits, variates):
  """(embedding, KL of softmax(logits) to uniform): the straight-through
  smoothed top-k of the logits perturbed by the Gamma(1/k) variates
  (N_GAMMA_TERMS, B, latent_size)."""
  k = m.latent_k
  log_q = torch.log_softmax(logits, dim=-1)
  kl = torch.sum(log_q.exp() * (log_q + math.log(m.latent_size)), dim=-1)
  beta = k / torch.arange(1.0, N_GAMMA_TERMS + 1.0, device=logits.device)
  noise = GAMMA_TAU * (torch.sum(variates / beta[:, None, None], dim=0)
                       - math.log(N_GAMMA_TERMS)) / k
  x = logits + noise
  x = x - x.mean(dim=-1, keepdim=True)
  soft = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
  kth = torch.topk(x, k, dim=-1).values[..., -1:]
  hard = (x >= kth).float()
  return (hard - soft).detach() + soft, kl


def gamma_t(p, m: Model, emb, t):
  """(gamma, dgamma/dt) at t (B,), each (B, n_pixels) in NHWC order."""
  h = F.silu(F.linear(emb, p['gamma.dense_1.weight'], p['gamma.dense_1.bias']))
  h = F.silu(F.linear(h, p['gamma.dense_2.weight'], p['gamma.dense_2.bias']))
  a = F.linear(h, p['gamma.dense_out_a.weight'], p['gamma.dense_out_a.bias'])
  b = F.linear(h, p['gamma.dense_out_b.weight'], p['gamma.dense_out_b.bias'])
  c = 1e-3 + F.softplus(F.linear(h, p['gamma.dense_out_c.weight'],
                                 p['gamma.dense_out_c.bias']))
  t = t[:, None]
  integral = (a * a * t ** 5 / 5.0 + (b * b + 2 * a * c) * t ** 3 / 3.0
              + a * b * t ** 4 / 2.0 + b * c * t ** 2 + c * c * t)
  total = (a * a / 5.0 + (b * b + 2 * a * c) / 3.0 + a * b / 2.0 + b * c
           + c * c)
  span = m.gamma_max - m.gamma_min
  quad = a * t * t + b * t + c
  return m.gamma_min + span * integral / total, span * quad * quad / total


def encode(x, vocab_size):
  return 2.0 * ((torch.round(x.float()) + 0.5) / vocab_size) - 1.0


def decoder_logprob(x, z, g0, vocab_size):
  """Summed log p(x | z) of the categorical decoder, (B,): logits
  -0.5 ((z - e_v) e^(-g0/2))^2 over the vocabulary's bins e_v."""
  vals = encode(torch.arange(vocab_size, device=z.device), vocab_size)
  inv = math.exp(-0.5 * g0)
  logits = -0.5 * torch.square((z[..., None] - vals) * inv)
  lx = -0.5 * torch.square((z - encode(x, vocab_size)) * inv)
  return (lx - torch.logsumexp(logits, dim=-1)).flatten(1).sum(1)


@dataclasses.dataclass
class Noise:
  """What one pass draws: times t (B,), the latent's Gamma variates
  (N_GAMMA_TERMS, B, latent_size), eps0 and eps (B, H, W, C)."""
  t: torch.Tensor
  variates: torch.Tensor
  eps0: torch.Tensor
  eps: torch.Tensor

  def rows(self, lo, hi):
    return Noise(self.t[lo:hi], self.variates[:, lo:hi], self.eps0[lo:hi],
                 self.eps[lo:hi])


def elbo_bpd(p, m: Model, images, noise: Noise, num: Numerics = FLOAT32,
             dropout_seed: Optional[int] = None, first_row: int = 0,
             logits=None):
  """Per-example bits per dimension (B,) of the ELBO: reconstruction +
  prior and latent KL + diffusion. `dropout_seed` None is the
  deterministic pass; `first_row` is the images' first row in the global
  batch (the dropout masks' rows). `logits` (B, latent_size), if given,
  stand in for the encoder."""
  x = images.reshape(-1, m.image_size, m.image_size, m.channels)
  f = encode(x, m.vocab_size)
  drop = (None if dropout_seed is None
          else Dropout(dropout_seed, m.pdrop, first_row))
  f_nchw = f.permute(0, 3, 1, 2)
  if logits is None:
    logits = encoder_logits(p, m, f_nchw, num, drop)
  emb, kl_z = topk_embedding(m, logits, noise.variates)
  g_t, dg_t = (g.reshape(x.shape) for g in gamma_t(p, m, emb, noise.t))
  g0, g1 = m.gamma_min, m.gamma_max
  var_t, var_1 = torch.sigmoid(g_t), 1.0 / (1.0 + math.exp(-g1))
  z0 = f + math.exp(0.5 * g0) * noise.eps0
  loss_recon = -decoder_logprob(x, z0, g0, m.vocab_size)
  loss_klz = 0.5 * torch.sum((1.0 - var_1) * f * f + var_1 - math.log(var_1)
                             - 1.0, dim=(1, 2, 3))
  z_t = torch.sqrt(1.0 - var_t) * f + torch.sqrt(var_t) * noise.eps
  out = score_unet(p, m, z_t.permute(0, 3, 1, 2), g_t.mean(dim=(1, 2, 3)),
                   emb, num, drop).permute(0, 2, 3, 1)
  if m.parameterization == 'epsilon':
    loss_diff = 0.5 * torch.sum(dg_t * torch.square(noise.eps - out),
                                dim=(1, 2, 3))
  else:
    target = torch.sqrt(1.0 - var_t) * noise.eps - torch.sqrt(var_t) * f
    loss_diff = 0.5 * torch.sum((1.0 - var_t) * dg_t
                                * torch.square(target - out), dim=(1, 2, 3))
  nats = loss_recon + loss_klz + kl_z + loss_diff
  return nats / (m.n_pixels * LN2)


# -- the noise of a step and of a dense chunk ----------------------------------


def step_key(seed: int, stream: int, index: int) -> int:
  """A 63-bit generator seed from (seed, stream, index): numpy's
  SeedSequence hash of the three, two words of its state."""
  words = np.random.SeedSequence((seed, stream, index)).generate_state(
      2, np.uint32)
  return (int(words[0]) << 31) ^ int(words[1])


def draw_train_noise(m: Model, gen: torch.Generator, batch: int, device):
  """The draws of one train step, in their order: one uniform for the
  antithetic times, the latent's Gamma(1/k) variates, eps0, eps."""
  u = torch.rand((), generator=gen, device=device)
  t = torch.remainder(u + torch.arange(batch, dtype=torch.float32,
                                       device=device) / batch, 1.0)
  return _draw_rest(m, gen, t, device)


def _draw_rest(m, gen, t, device):
  b = t.shape[0]
  alpha = torch.full((N_GAMMA_TERMS, b, m.latent_size), 1.0 / m.latent_k,
                     device=device)
  variates = torch._standard_gamma(alpha, generator=gen)
  shape = (b, m.image_size, m.image_size, m.channels)
  eps0 = torch.randn(shape, generator=gen, device=device)
  eps = torch.randn(shape, generator=gen, device=device)
  return Noise(t, variates, eps0, eps)


def train_step_noise(m: Model, seed: int, step: int, batch: int, device):
  """(noise, dropout seed) of train step `step` (0 before the first update)
  of a run seeded `seed`: the generator is reseeded from (seed, 0, step),
  and the dropout seed is that key modulo 2^31 - 1."""
  key = step_key(seed, 0, step)
  gen = torch.Generator(device).manual_seed(key)
  return draw_train_noise(m, gen, batch, device), key % (2 ** 31 - 1)


def dense_chunk_noise(m: Model, gen: torch.Generator, images: int,
                      n_timesteps: int, device):
  """The draws of one dense-VLB chunk of `images` images on the grid
  t_j = (u_i + j / n) mod 1: the offsets u (images,), then the rows'
  latent variates, eps0 and eps, image-major."""
  u = torch.rand((images,), generator=gen, device=device)
  steps = torch.arange(n_timesteps, device=device) / n_timesteps
  t = torch.remainder(u[:, None] + steps, 1.0).reshape(-1)
  return _draw_rest(m, gen, t, device)
