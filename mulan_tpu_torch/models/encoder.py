"""Latent encoders q(z_x | x), counterparts of `mulan_tpu/models/encoder.py`:
`UnetEncoder` (latent logits), `UnetEncoderGaussian` (mu and a softplus
variance from two heads on the same trunk) and `CNNEncoder` (two ReLU
convolutions and a Dense layer, `encoder='cnn'`).

The trunk embeds a constant t = 0 / conditioning = 0 vector through learned
Dense layers, as the score UNet embeds its time, then runs conv_in,
`forward_n_layer` ResNet blocks, a ResNet-Attn-ResNet middle and a 1-channel
head, flattened in NHWC order before the final Dense layer. With a
`dropout_seed` its 4 + 2 ResNet blocks drop at sites numbered after the
score UNet's, so that no two blocks of a MuLAN share a mask.

As in JAX (`mulan_tpu/models/encoder.py:53-71`), `with_attention` adds
`down_attn_{i}` after each down block and `remat` checkpoints every block
('all') or the attention blocks ('attn', 'alt'); the trunk takes neither
`fused_gn_swish` nor `dropout_mask_batch`, so its blocks keep the unfused
GroupNorm and their own masks (K6).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.layers import (FOURIER_MULT, AttnBlock, Conv2d,
                                           GroupNormF32, Linear, ResnetBlock,
                                           base2_fourier_features,
                                           timestep_embedding)
from mulan_tpu_torch.models.unet import UNet


class UnetTrunk(nn.Module):

  def __init__(self, config: ModelConfig):
    super().__init__()
    cfg = self.config = config
    n_embd = cfg.sm_n_embd
    c = cfg.image_channels
    cond_dim = 4 * n_embd
    self.dense0 = Linear(n_embd + 1, cond_dim)
    self.dense1 = Linear(cond_dim, cond_dim)
    in_ch = c * FOURIER_MULT if cfg.with_fourier_features else c
    self.conv_in = Conv2d(in_ch, n_embd, 3, padding=1)
    first = UNet.n_sites(cfg)
    sites = iter(range(first, first + self.n_sites(cfg)))

    def block():
      return ResnetBlock(n_embd, n_embd, cond_dim, pdrop=cfg.sm_pdrop,
                         site=next(sites), use_kernels=cfg.use_kernels,
                         remat=cfg.remat_blocks)

    def attn():
      return AttnBlock(n_embd, cfg.use_kernels, remat=cfg.remat_attn)

    for i in range(cfg.forward_n_layer):
      self.add_module(f'down_block_{i}', block())
      if cfg.with_attention:
        self.add_module(f'down_attn_{i}', attn())
    self.mid_block_1 = block()
    self.mid_attn_1 = attn()
    self.mid_block_2 = block()
    self.GroupNormF32_0 = GroupNormF32(n_embd, use_kernels=cfg.use_kernels)
    self.conv_out = Conv2d(n_embd, 1, 3, padding=1)

  @staticmethod
  def n_sites(config: ModelConfig) -> int:
    return config.forward_n_layer + 2

  def forward(self, z, dropout_seed=None, dropout_row: int = 0):
    """z (B, C, H, W) float32 -> (B, H * W) float32; z holds rows
    `dropout_row` on of the global batch."""
    cfg = self.config
    dtype = cfg.dtype
    b = z.shape[0]
    t = torch.zeros((b,), device=z.device)
    cond = torch.cat([timestep_embedding(t, cfg.sm_n_embd),
                      torch.zeros((b, 1), device=z.device)], dim=1)
    cond = F.silu(self.dense0(cond.to(dtype)))
    cond = F.silu(self.dense1(cond))

    h = z
    if cfg.with_fourier_features:
      h = torch.cat([z, base2_fourier_features(z)], dim=1)
    h = self.conv_in(h.to(dtype))
    for i in range(cfg.forward_n_layer):
      h = getattr(self, f'down_block_{i}')(h, cond, dropout_seed,
                                             dropout_row=dropout_row)
      if cfg.with_attention:
        h = getattr(self, f'down_attn_{i}')(h)
    h = self.mid_block_1(h, cond, dropout_seed, dropout_row=dropout_row)
    h = self.mid_attn_1(h)
    h = self.mid_block_2(h, cond, dropout_seed, dropout_row=dropout_row)
    h = self.conv_out(self.GroupNormF32_0.gn_swish(h))
    # NHWC flatten, as the JAX trunk does (the same order for one channel).
    return F.silu(h.permute(0, 2, 3, 1).reshape(b, -1).float())


class UnetEncoder(nn.Module):
  """Trunk in the compute type, then a float32 Dense to the latent logits."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.trunk = UnetTrunk(config)
    self.dense_layer_final = nn.Linear(config.image_size ** 2,
                                       config.latent_size)

  def forward(self, z, dropout_seed=None, dropout_row: int = 0):
    return self.dense_layer_final(self.trunk(z, dropout_seed, dropout_row))


class UnetEncoderGaussian(nn.Module):
  """The trunk with two float32 heads: (mu, softplus(sigma)), the second
  used as the latent's variance (`encoder.py:90-101`)."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.trunk = UnetTrunk(config)
    self.dense_layer_final_mu = nn.Linear(config.image_size ** 2,
                                          config.latent_size)
    self.dense_layer_final_sigma = nn.Linear(config.image_size ** 2,
                                             config.latent_size)

  def forward(self, z, dropout_seed=None, dropout_row: int = 0):
    h = self.trunk(z, dropout_seed, dropout_row)
    return (self.dense_layer_final_mu(h),
            F.softplus(self.dense_layer_final_sigma(h)))


class CNNEncoder(nn.Module):
  """conv3x3 (32) - ReLU - conv3x3 (16) - ReLU, flattened in NHWC order,
  then a Dense layer to the latent logits; float32 throughout, as flax's
  modules without a `dtype` run (`encoder.py:104-114`). It has no dropout."""

  def __init__(self, config: ModelConfig):
    super().__init__()
    self.conv1 = nn.Conv2d(config.image_channels, 32, 3, padding=1)
    self.conv2 = nn.Conv2d(32, 16, 3, padding=1)
    self.dense = nn.Linear(16 * config.image_size ** 2, config.latent_size)

  def forward(self, z, dropout_seed=None, dropout_row: int = 0):
    del dropout_seed, dropout_row
    h = F.relu(self.conv2(F.relu(self.conv1(z.float()))))
    return self.dense(h.permute(0, 2, 3, 1).flatten(1))


# `encoder` -> the logits encoder (`encoder.py:117`).
ENCODERS = {'cnn': CNNEncoder, 'unet': UnetEncoder}
