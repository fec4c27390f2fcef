"""Score UNet with a scalar gamma per example, counterpart of
`mulan_tpu/models/unet.py:UNet(per_pixel_gamma=False)`.

No spatial down/upsampling: `sm_n_layer` ResNet blocks at full resolution
with a skip stack, a ResNet-Attn-ResNet middle, `sm_n_layer + 1` up blocks
over concatenated skips, and a final conv whose output is added to z in
float32. Blocks run in `config.dtype`; the conditioning trigonometry and the
residual stay float32.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.layers import (FOURIER_MULT, AttnBlock,
                                           GroupNormF32, ResnetBlock,
                                           base2_fourier_features,
                                           timestep_embedding)


class UNet(nn.Module):

  def __init__(self, config: ModelConfig):
    super().__init__()
    cfg = self.config = config
    n_embd = cfg.sm_n_embd
    c = cfg.image_channels
    cond_dim = 4 * n_embd
    self.dense0 = nn.Linear(n_embd + cfg.latent_size, cond_dim)
    self.dense1 = nn.Linear(cond_dim, cond_dim)
    in_ch = c * FOURIER_MULT if cfg.with_fourier_features else c
    self.conv_in = nn.Conv2d(in_ch, n_embd, 3, padding=1)
    for i in range(cfg.sm_n_layer):
      self.add_module(f'down_block_{i}', ResnetBlock(n_embd, n_embd,
                                                     cond_dim))
    self.mid_block_1 = ResnetBlock(n_embd, n_embd, cond_dim)
    self.mid_attn_1 = AttnBlock(n_embd, cfg.use_kernels)
    self.mid_block_2 = ResnetBlock(n_embd, n_embd, cond_dim)
    for i in range(cfg.sm_n_layer + 1):
      self.add_module(f'up_block_{i}', ResnetBlock(2 * n_embd, n_embd,
                                                   cond_dim))
    self.GroupNormF32_0 = GroupNormF32(n_embd)
    self.conv_out = nn.Conv2d(n_embd, c, 3, padding=1)

  def forward(self, z, g_t, conditioning):
    """z (B, C, H, W), g_t (B,) mean gamma, conditioning (B, latent)."""
    cfg = self.config
    dtype = self.conv_in.weight.dtype
    z = z.float()
    t = (g_t.float() - cfg.gamma_min) / (cfg.gamma_max - cfg.gamma_min)
    cond = torch.cat([timestep_embedding(t, cfg.sm_n_embd),
                      conditioning.float()], dim=-1)
    cond = F.silu(self.dense0(cond.to(dtype)))
    cond = F.silu(self.dense1(cond))

    h = z
    if cfg.with_fourier_features:
      h = torch.cat([z, base2_fourier_features(z)], dim=1)
    hs = [self.conv_in(h.to(dtype))]
    for i in range(cfg.sm_n_layer):
      hs.append(getattr(self, f'down_block_{i}')(hs[-1], cond))
    h = self.mid_block_1(hs[-1], cond)
    h = self.mid_attn_1(h)
    h = self.mid_block_2(h, cond)
    for i in range(cfg.sm_n_layer + 1):
      h = getattr(self, f'up_block_{i}')(torch.cat([h, hs.pop()], dim=1),
                                         cond)
    assert not hs
    eps_pred = self.conv_out(F.silu(self.GroupNormF32_0(h)))
    return eps_pred.float() + z
