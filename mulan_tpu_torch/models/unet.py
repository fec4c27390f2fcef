"""Score UNet with a scalar gamma per example, counterpart of
`mulan_tpu/models/unet.py:UNet(per_pixel_gamma=False)`.

No spatial down/upsampling: `sm_n_layer` ResNet blocks at full resolution
with a skip stack, a ResNet-Attn-ResNet middle, `sm_n_layer + 1` up blocks
over concatenated skips, and a final conv whose output is added to z in
float32. The conditioning beside the time embedding is MuLAN's latent
embedding (`latent_size` wide, the default) or the VDM's one column of
zeros (`conditioning_width=1`). Blocks run in `config.dtype` on float32
parameters cast at use; the conditioning trigonometry and the residual
stay float32.

With a `dropout_seed`, each of the 2 n_layer + 3 ResNet blocks drops with
`sm_pdrop` at its own site (down blocks first, then mid, then up), so its
mask is keyed by (dropout_seed, site); without one the pass is
deterministic. With `dropout_mask_batch` all of those masks are made at
once before the blocks (K7 with `use_kernels`, one launch) and block i is
handed slot i, which the backward reads again; without it each block makes
its own mask and the backward regenerates it (K6). JAX takes the batched
path only with `use_pallas` too (`mulan_tpu/models/unet.py:102`), because
its off-TPU masks come from another generator; here both paths give the
same bits, so the flag alone decides.

The execution-policy flags follow `mulan_tpu/models/unet.py:89-154`:
`fused_gn_swish` fuses both GN-swish sites of every ResNet block (not the
final GroupNorm); `with_attention` adds `down_attn_{i}` after every down
block and `up_attn_{i}` after every up block; `remat` checkpoints every
block ('all'), every attention block ('attn'), or the attention blocks and
the even-numbered ResNet blocks in site order ('alt').
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.models.layers import (FOURIER_MULT, AttnBlock, Conv2d,
                                           GroupNormF32, Linear, ResnetBlock,
                                           base2_fourier_features,
                                           timestep_embedding)
from mulan_tpu_torch.ops import dropout as dropout_ops


class UNet(nn.Module):

  def __init__(self, config: ModelConfig,
               conditioning_width: Optional[int] = None):
    super().__init__()
    cfg = self.config = config
    n_embd = cfg.sm_n_embd
    c = cfg.image_channels
    cond_dim = 4 * n_embd
    if conditioning_width is None:
      conditioning_width = cfg.latent_size
    self.dense0 = Linear(n_embd + conditioning_width, cond_dim)
    self.dense1 = Linear(cond_dim, cond_dim)
    in_ch = c * FOURIER_MULT if cfg.with_fourier_features else c
    self.conv_in = Conv2d(in_ch, n_embd, 3, padding=1)
    sites = iter(range(self.n_sites(cfg)))

    def block(in_ch):
      site = next(sites)
      return ResnetBlock(
          in_ch, n_embd, cond_dim, pdrop=cfg.sm_pdrop, site=site,
          use_kernels=cfg.use_kernels, fused_gn=cfg.fused_gn_swish,
          remat=cfg.remat_blocks or (cfg.remat_alt_blocks and site % 2 == 0))

    def attn():
      return AttnBlock(n_embd, cfg.use_kernels, remat=cfg.remat_attn)

    for i in range(cfg.sm_n_layer):
      self.add_module(f'down_block_{i}', block(n_embd))
      if cfg.with_attention:
        self.add_module(f'down_attn_{i}', attn())
    self.mid_block_1 = block(n_embd)
    self.mid_attn_1 = attn()
    self.mid_block_2 = block(n_embd)
    for i in range(cfg.sm_n_layer + 1):
      self.add_module(f'up_block_{i}', block(2 * n_embd))
      if cfg.with_attention:
        self.add_module(f'up_attn_{i}', attn())
    self.GroupNormF32_0 = GroupNormF32(n_embd)
    self.conv_out = Conv2d(n_embd, c, 3, padding=1)

  @staticmethod
  def n_sites(config: ModelConfig) -> int:
    """Dropout sites: one per ResNet block."""
    return 2 * config.sm_n_layer + 3

  def forward(self, z, g_t, conditioning, dropout_seed=None):
    """z (B, C, H, W), g_t (B,) mean gamma, conditioning (B,
    conditioning_width); dropout_seed None is the deterministic pass."""
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

    masks = None
    if (cfg.dropout_mask_batch and dropout_seed is not None
        and cfg.sm_pdrop > 0):
      # Every block's mask is (B, n_embd, H, W): all project to n_embd
      # before the dropout site.
      masks = dropout_ops.dropout_masks(
          dropout_seed, 0, self.n_sites(cfg),
          (z.shape[0], cfg.sm_n_embd, *z.shape[2:]), cfg.sm_pdrop, dtype,
          z.device, cfg.use_kernels)
    used = []

    def res_block(name, h):
      block = getattr(self, name)
      mask = None
      if masks is not None:
        mask = masks[block.site]
        used.append(block.site)
      return block(h, cond, dropout_seed, mask)

    def attn_block(name, h):
      return getattr(self, name)(h) if cfg.with_attention else h

    for i in range(cfg.sm_n_layer):
      h = res_block(f'down_block_{i}', hs[-1])
      hs.append(attn_block(f'down_attn_{i}', h))
    h = res_block('mid_block_1', hs[-1])
    h = self.mid_attn_1(h)
    h = res_block('mid_block_2', h)
    for i in range(cfg.sm_n_layer + 1):
      h = res_block(f'up_block_{i}', torch.cat([h, hs.pop()], dim=1))
      h = attn_block(f'up_attn_{i}', h)
    assert not hs
    if masks is not None:
      assert used == list(range(masks.shape[0])), (used, masks.shape)
    eps_pred = self.conv_out(F.silu(self.GroupNormF32_0(h)))
    return eps_pred.float() + z
