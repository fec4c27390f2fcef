"""Score UNet, counterpart of `mulan_tpu/models/unet.py:UNet`: conditioned
on a scalar gamma per example (the 'vdm' UNet) or, with
`per_pixel_gamma` (`unet_type='ldm'`), on the whole gamma map.

No spatial down/upsampling: `sm_n_layer` ResNet blocks at full resolution
with a skip stack, a ResNet-Attn-ResNet middle, `sm_n_layer + 1` up blocks
over concatenated skips, and a final conv whose output is added to z in
float32. The conditioning beside the time embedding is MuLAN's latent
embedding (`latent_size` wide, the default) or the VDM's one column of
zeros (`conditioning_width=1`). With `per_pixel_gamma` each pixel's
gamma is embedded on its own: the map (B, H, W, C) becomes (B, H, W,
C n_embd), each channel's n_embd features together, as JAX lays them out
(`unet.py:57-67`); the conditioning is broadcast over the pixels beside it,
and `dense0` and `dense1` run per pixel, so each ResNet block adds a bias
per pixel. Blocks run in `config.dtype` on float32 parameters cast at use;
the conditioning trigonometry and the residual stay float32.

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

With a `tensor` group (`training.tp` > 1, `parallel/tensor.py`) the UNet
is column-parallel, as JAX's is on a mesh with a 'tensor' axis
(`constrain_activation_channels` on every block output): `dense0`,
`dense1`, `conv_in` and every block hold the rank's slice of their output
channels; the conditioning is gathered whole after each dense layer, the
activations between blocks are the rank's channels of (B, sm_n_embd, H, W)
(an up block's input [h, skip] the rank's slice of each), each site's
dropout mask is the rank's channel window of the global one, and the
final GroupNorm's output is gathered for `conv_out`, which every rank
computes whole. z, the gamma map and the conditioning come in whole on
every rank, and the output is whole on every rank.
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
from mulan_tpu_torch.parallel import tensor as tensor_lib


class UNet(nn.Module):

  def __init__(self, config: ModelConfig,
               conditioning_width: Optional[int] = None,
               per_pixel_gamma: bool = False,
               tensor: Optional[tensor_lib.TensorGroup] = None):
    super().__init__()
    cfg = self.config = config
    self.tensor = tensor
    n_embd = cfg.sm_n_embd
    c = cfg.image_channels
    cond_dim = 4 * n_embd
    if conditioning_width is None:
      conditioning_width = cfg.latent_size
    self.conditioning_width = conditioning_width
    self.per_pixel_gamma = per_pixel_gamma
    temb_width = c * n_embd if per_pixel_gamma else n_embd
    cond_local = tensor_lib.part(cond_dim, tensor)
    self.dense0 = Linear(temb_width + conditioning_width, cond_local)
    self.dense1 = Linear(cond_dim, cond_local)
    in_ch = c * FOURIER_MULT if cfg.with_fourier_features else c
    self.conv_in = Conv2d(in_ch, tensor_lib.part(n_embd, tensor), 3,
                          padding=1)
    sites = iter(range(self.n_sites(cfg)))

    def block(in_ch):
      site = next(sites)
      return ResnetBlock(
          in_ch, n_embd, cond_dim, pdrop=cfg.sm_pdrop, site=site,
          use_kernels=cfg.use_kernels, fused_gn=cfg.fused_gn_swish,
          remat=cfg.remat_blocks or (cfg.remat_alt_blocks and site % 2 == 0),
          tensor=tensor, in_segments=in_ch // n_embd)

    def attn():
      return AttnBlock(n_embd, cfg.use_kernels, remat=cfg.remat_attn,
                       tensor=tensor)

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
    self.GroupNormF32_0 = GroupNormF32(n_embd, use_kernels=cfg.use_kernels,
                                       tensor=tensor)
    self.conv_out = Conv2d(n_embd, c, 3, padding=1)

  @staticmethod
  def n_sites(config: ModelConfig) -> int:
    """Dropout sites: one per ResNet block."""
    return 2 * config.sm_n_layer + 3

  def forward(self, z, g_t, conditioning, dropout_seed=None,
              dropout_row: int = 0):
    """z (B, C, H, W); g_t (B,), the mean gamma, or with `per_pixel_gamma`
    the gamma map (B, H, W, C); conditioning (B, conditioning_width);
    dropout_seed None is the deterministic pass. z holds rows
    `dropout_row` on of the global batch (a data-parallel rank's), whose
    rows of each site's mask the blocks take."""
    cfg = self.config
    dtype = cfg.dtype
    z = z.float()
    if conditioning.shape[-1] != self.conditioning_width:
      raise ValueError(
          f'the score UNet takes conditioning {self.conditioning_width} '
          f'wide, got {tuple(conditioning.shape)}: flax refuses it at '
          'dense0 (ScopeParamShapeError, mulan_tpu/models/unet.py:76)')
    t = (g_t.float() - cfg.gamma_min) / (cfg.gamma_max - cfg.gamma_min)
    if self.per_pixel_gamma:
      b, c, hgt, wid = z.shape
      assert t.shape == (b, hgt, wid, c), (t.shape, z.shape)
      temb = timestep_embedding(t.reshape(-1), cfg.sm_n_embd).reshape(
          b, hgt, wid, c * cfg.sm_n_embd)
      cond = torch.cat([temb, conditioning.float()[:, None, None, :].expand(
          b, hgt, wid, -1)], dim=-1)
    else:
      cond = torch.cat([timestep_embedding(t, cfg.sm_n_embd),
                        conditioning.float()], dim=-1)
    tensor = self.tensor
    cond = F.silu(self.dense0(tensor_lib.enter(cond.to(dtype), tensor)))
    cond = F.silu(self.dense1(tensor_lib.gather(cond, tensor, -1)))
    cond = tensor_lib.gather(cond, tensor, -1)

    h = z
    if cfg.with_fourier_features:
      h = torch.cat([z, base2_fourier_features(z)], dim=1)
    hs = [self.conv_in(tensor_lib.enter(h.to(dtype), tensor))]

    masks = None
    if (cfg.dropout_mask_batch and dropout_seed is not None
        and cfg.sm_pdrop > 0):
      # Every block's mask is (B, n_embd, H, W) (the rank's channels of
      # it): all project to n_embd before the dropout site.
      masks = dropout_ops.dropout_masks(
          dropout_seed, 0, self.n_sites(cfg),
          (z.shape[0], tensor_lib.part(cfg.sm_n_embd, tensor),
           *z.shape[2:]), cfg.sm_pdrop, dtype, z.device, cfg.use_kernels,
          dropout_row, None if tensor is None else tensor.window(
              cfg.sm_n_embd))
    used = []

    def res_block(name, h):
      block = getattr(self, name)
      mask = None
      if masks is not None:
        mask = masks[block.site]
        used.append(block.site)
      return block(h, cond, dropout_seed, mask, dropout_row)

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
    h = tensor_lib.gather(self.GroupNormF32_0.gn_swish(h), tensor, 1,
                          grad='slice')
    eps_pred = self.conv_out(h)
    return eps_pred.float() + z
