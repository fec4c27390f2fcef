"""Score UNet with a scalar gamma per example, counterpart of
`mulan_tpu/models/unet.py:UNet(per_pixel_gamma=False)`.

No spatial down/upsampling: `sm_n_layer` ResNet blocks at full resolution
with a skip stack, a ResNet-Attn-ResNet middle, `sm_n_layer + 1` up blocks
over concatenated skips, and a final conv whose output is added to z in
float32. Blocks run in `config.dtype` on float32 parameters cast at use; the
conditioning trigonometry and the residual stay float32.

With a `dropout_seed`, each of the 2 n_layer + 3 ResNet blocks drops with
`sm_pdrop` at its own site (down blocks first, then mid, then up), so its
mask is keyed by (dropout_seed, site); without one the pass is
deterministic.
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


class UNet(nn.Module):

  def __init__(self, config: ModelConfig):
    super().__init__()
    cfg = self.config = config
    n_embd = cfg.sm_n_embd
    c = cfg.image_channels
    cond_dim = 4 * n_embd
    self.dense0 = Linear(n_embd + cfg.latent_size, cond_dim)
    self.dense1 = Linear(cond_dim, cond_dim)
    in_ch = c * FOURIER_MULT if cfg.with_fourier_features else c
    self.conv_in = Conv2d(in_ch, n_embd, 3, padding=1)
    sites = iter(range(self.n_sites(cfg)))

    def block(in_ch):
      return ResnetBlock(in_ch, n_embd, cond_dim, pdrop=cfg.sm_pdrop,
                         site=next(sites), use_kernels=cfg.use_kernels)

    for i in range(cfg.sm_n_layer):
      self.add_module(f'down_block_{i}', block(n_embd))
    self.mid_block_1 = block(n_embd)
    self.mid_attn_1 = AttnBlock(n_embd, cfg.use_kernels)
    self.mid_block_2 = block(n_embd)
    for i in range(cfg.sm_n_layer + 1):
      self.add_module(f'up_block_{i}', block(2 * n_embd))
    self.GroupNormF32_0 = GroupNormF32(n_embd)
    self.conv_out = Conv2d(n_embd, c, 3, padding=1)

  @staticmethod
  def n_sites(config: ModelConfig) -> int:
    """Dropout sites: one per ResNet block."""
    return 2 * config.sm_n_layer + 3

  def forward(self, z, g_t, conditioning, dropout_seed=None):
    """z (B, C, H, W), g_t (B,) mean gamma, conditioning (B, latent);
    dropout_seed None is the deterministic pass."""
    cfg = self.config
    dtype = cfg.dtype
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
      hs.append(getattr(self, f'down_block_{i}')(hs[-1], cond, dropout_seed))
    h = self.mid_block_1(hs[-1], cond, dropout_seed)
    h = self.mid_attn_1(h)
    h = self.mid_block_2(h, cond, dropout_seed)
    for i in range(cfg.sm_n_layer + 1):
      h = getattr(self, f'up_block_{i}')(torch.cat([h, hs.pop()], dim=1),
                                         cond, dropout_seed)
    assert not hs
    eps_pred = self.conv_out(F.silu(self.GroupNormF32_0(h)))
    return eps_pred.float() + z
