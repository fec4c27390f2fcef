"""The floating-point operations the model needs, from the configuration's
shapes alone.

Counted are the products: convolutions, 1x1 and dense layers, the
attention's projections and its two T x T products, the schedule network.
A multiply-add is two operations. Normalisations, activations and the
decoder's bins are not counted. A train step needs its forward once and a
backward of twice the forward; recomputation is not counted. Nothing here
reads the program, so removing or fusing a kernel does not change the
count.
"""

from __future__ import annotations

from benchmark.reference.mulan import FOURIER_EXPONENTS, Model

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense, at 700 W


def conv(c_in: int, c_out: int, k: int, pixels: int) -> int:
  return 2 * c_in * c_out * k * k * pixels


def dense(n_in: int, n_out: int) -> int:
  return 2 * n_in * n_out


def resnet_block(c_in: int, c_out: int, cond: int, pixels: int) -> int:
  flops = (conv(c_in, c_out, 3, pixels) + conv(c_out, c_out, 3, pixels)
           + dense(cond, c_out))
  if c_in != c_out:
    flops += conv(c_in, c_out, 1, pixels)
  return flops


def attention_block(c: int, tokens: int) -> int:
  """q, k, v and the output projection, Q K^T and P V (one head of c)."""
  return 4 * tokens * dense(c, c) + 2 * (2 * tokens * tokens * c)


def _input_channels(m: Model) -> int:
  return m.channels * (1 + 2 * len(FOURIER_EXPONENTS))


def score_unet(m: Model) -> int:
  """One image through the score UNet."""
  c, cond, px = m.n_embd, 4 * m.n_embd, m.image_size ** 2
  flops = dense(c + m.latent_size, cond) + dense(cond, cond)
  flops += conv(_input_channels(m), c, 3, px)
  flops += (m.n_layer + 2) * resnet_block(c, c, cond, px)
  flops += attention_block(c, px)
  flops += (m.n_layer + 1) * resnet_block(2 * c, c, cond, px)
  return flops + conv(c, m.channels, 3, px)


def encoder(m: Model) -> int:
  """One image through the latent encoder."""
  c, cond, px = m.n_embd, 4 * m.n_embd, m.image_size ** 2
  flops = dense(c + 1, cond) + dense(cond, cond)
  flops += conv(_input_channels(m), c, 3, px)
  flops += (m.encoder_layers + 2) * resnet_block(c, c, cond, px)
  flops += attention_block(c, px)
  return flops + conv(c, 1, 3, px) + dense(px, m.latent_size)


def gamma_network(m: Model) -> int:
  """The schedule's coefficients for one embedding."""
  n = m.n_pixels
  return dense(m.latent_size, n) + 4 * dense(n, n)


def train_step(m: Model, batch: int) -> int:
  return 3 * batch * (score_unet(m) + encoder(m) + gamma_network(m))


def dense_chunk(m: Model, images: int, n_timesteps: int) -> int:
  """One dense-VLB chunk: the encoder once an image, the rest a row."""
  rows = images * n_timesteps
  return images * encoder(m) + rows * (score_unet(m) + gamma_network(m))
