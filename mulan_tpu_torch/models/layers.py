"""Shared neural blocks, counterpart of `mulan_tpu/models/layers.py`.

Blocks run NCHW. Submodules carry the flax module names (`GroupNormF32_0`,
`conv1`, `cond_proj`, ...) so that `params.from_flax` maps a flax tree leaf
by leaf. Parameters are float32; `Conv2d`, `Linear` and `GroupNormF32` cast
them to the activation's type at use (`cast_param`), as flax's
`nn.Conv(dtype=...)` and `nn.Dense(dtype=...)` do, so the master weights an
optimizer updates stay float32 under bfloat16 compute.

`ResnetBlock` and `AttnBlock` take `remat`: their forward then runs under
activation checkpointing (`maybe_remat`), the counterpart of JAX's
`maybe_remat` / `nn.remat` (`mulan_tpu/models/layers.py:214-224`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mulan_tpu_torch.ops import dropout as dropout_ops
from mulan_tpu_torch.ops import groupnorm_swish as gn_ops
from mulan_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
  """`module`'s parameter `name` (or None) in `dtype`.

  Under autograd the cast is part of the graph, as in flax. Without autograd
  (evaluation, sampling) the cast is kept on the module and reused until the
  parameter changes: every in-place update (an optimizer step, the EMA's
  lerp, `load_state_dict`) moves its version counter and `Module.to` gives
  it new storage, and either makes the next call cast afresh. So the
  sampler's UNet passes do not recast every weight on every step.
  """
  p = getattr(module, name)
  if p is None or p.dtype == dtype:
    return p
  if torch.is_grad_enabled():
    return p.to(dtype)
  key = (dtype, p.data_ptr(), p._version)
  cache = module.__dict__.setdefault('_casts', {})
  if name not in cache or cache[name][0] != key:
    cache[name] = (key, p.to(dtype))
  return cache[name][1]


class Conv2d(nn.Conv2d):
  """A convolution whose float32 weight and bias are cast to the input's
  type inside `forward`."""

  def forward(self, x):
    return F.conv2d(x, cast_param(self, 'weight', x.dtype),
                    cast_param(self, 'bias', x.dtype), self.stride,
                    self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
  """A dense layer whose float32 weight and bias are cast to the input's
  type inside `forward`."""

  def forward(self, x):
    return F.linear(x, cast_param(self, 'weight', x.dtype),
                    cast_param(self, 'bias', x.dtype))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
  """Sinusoidal embedding of t scaled by 1000; (B,) -> (B, dim) float32,
  dim even."""
  assert t.dim() == 1 and dim % 2 == 0
  t = t.float() * 1000.0
  half = dim // 2
  freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                    * (-math.log(10000.0) / (half - 1)))
  args = t[:, None] * freqs[None, :]
  return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# Fourier features at 2^6 and 2^7 (the JAX UNets' start=6, stop=8): a
# network input of C channels becomes C * FOURIER_MULT channels.
_FOURIER_EXPONENTS = (6, 7)
FOURIER_MULT = 1 + 2 * len(_FOURIER_EXPONENTS)


def base2_fourier_features(x: torch.Tensor) -> torch.Tensor:
  """sin/cos of x * 2^k * 2 pi for k in _FOURIER_EXPONENTS, NCHW.

  Channel order as in the JAX package: each input channel is repeated once
  per frequency against the frequencies tiled over channels, then all sines
  followed by all cosines.
  """
  n_freq = len(_FOURIER_EXPONENTS)
  w = 2.0 ** torch.tensor(_FOURIER_EXPONENTS, dtype=x.dtype,
                          device=x.device) * 2 * math.pi
  w = w.repeat(x.shape[1])[None, :, None, None]
  h = w * torch.repeat_interleave(x, n_freq, dim=1)
  return torch.cat([torch.sin(h), torch.cos(h)], dim=1)


class DenseMonotone(nn.Module):
  """x @ |kernel| + bias: monotone non-decreasing in its inputs
  (`mulan_tpu/models/layers.py:DenseMonotone`). The kernel keeps flax's
  (in, out) layout, so `params.from_flax` copies it as it is. float32."""

  def __init__(self, in_features: int, out_features: int,
               use_bias: bool = True):
    super().__init__()
    self.kernel = nn.Parameter(torch.empty(in_features, out_features))
    self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                 else None)

  def forward(self, x):
    y = x.float() @ self.kernel.abs()
    return y if self.bias is None else y + self.bias


def maybe_remat(fn, remat: bool, *args):
  """fn(*args), under activation checkpointing when `remat` is set and
  autograd is on: the forward keeps only fn's inputs, and the backward runs
  fn again to rebuild what it needs (non-reentrant
  `torch.utils.checkpoint`). Without autograd (evaluation, sampling) fn
  just runs.

  `preserve_rng_state=False`: nothing in a block draws from torch's
  generators. Every dropout mask comes from (seed, site) or is passed in,
  so the recompute rebuilds the same masks without the generator state
  being saved and restored around it.
  """
  if remat and torch.is_grad_enabled():
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)
  return fn(*args)


class GroupNormF32(nn.Module):
  """GroupNorm with float32 statistics, eps 1e-6 (flax's) and gcd(C, 32)
  groups; the output has the input's type.

  PyTorch's group_norm accumulates the statistics of bf16 input in float32,
  so the activation is not copied to float32 (as flax does, the affine
  parameters are applied in the input's type).

  With `fused_swish` it returns swish(groupnorm(x)) through
  `ops/groupnorm_swish.py:gn_swish` instead, the affine in float32 (the K8
  kernel with `use_kernels`, else its plain version), under the same
  parameters (`GroupNormF32_k/GroupNorm_0/{scale,bias}` in flax).
  """

  def __init__(self, channels: int, fused_swish: bool = False,
               use_kernels: bool = False):
    super().__init__()
    self.num_groups = math.gcd(channels, 32)
    self.fused_swish = fused_swish
    self.use_kernels = use_kernels
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x):
    if self.fused_swish:
      return gn_ops.gn_swish(x, self.weight, self.bias, self.num_groups, 1e-6,
                             self.use_kernels)
    return F.group_norm(x, self.num_groups,
                        cast_param(self, 'weight', x.dtype),
                        cast_param(self, 'bias', x.dtype), 1e-6)


class ResnetBlock(nn.Module):
  """GN-swish-conv3x3 (+ projected conditioning) GN-swish-dropout-conv3x3,
  plus a 1x1 `nin_shortcut` when the channel count changes.

  Dropout runs only when `forward` gets a `dropout_seed`: the mask is keyed
  by (dropout_seed, site), `site` being the block's fixed index in its
  model, and comes from the K6 kernel when `use_kernels` is set
  (`ops/dropout.py`). An explicit pre-scaled `dropout_mask` (NCHW, shaped
  like the activation) replaces it, as the JAX block's `dropout_mask`
  argument does; the product saves it for the backward.

  `fused_gn` computes both GN-swish sites in one pass each
  (`GroupNormF32(fused_swish=True)`, K8 with `use_kernels`).
  """

  def __init__(self, in_ch: int, out_ch: int, cond_dim: int, *,
               pdrop: float = 0.0, site: int = 0, use_kernels: bool = False,
               fused_gn: bool = False, remat: bool = False):
    super().__init__()
    self.pdrop = pdrop
    self.site = site
    self.use_kernels = use_kernels
    self.fused_gn = fused_gn
    self.remat = remat
    self.GroupNormF32_0 = GroupNormF32(in_ch, fused_gn, use_kernels)
    self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
    self.cond_proj = Linear(cond_dim, out_ch, bias=False)
    self.GroupNormF32_1 = GroupNormF32(out_ch, fused_gn, use_kernels)
    self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
    self.nin_shortcut = (Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                         else None)

  def _gn_swish(self, norm: GroupNormF32, h):
    return norm(h) if self.fused_gn else F.silu(norm(h))

  def forward(self, x, cond, dropout_seed=None, dropout_mask=None):
    return maybe_remat(self._forward, self.remat, x, cond, dropout_seed,
                       dropout_mask)

  def _forward(self, x, cond, dropout_seed, dropout_mask):
    h = self.conv1(self._gn_swish(self.GroupNormF32_0, x))
    h = h + self.cond_proj(cond)[:, :, None, None]
    h = self._gn_swish(self.GroupNormF32_1, h)
    if dropout_mask is not None:
      h = h * dropout_mask.to(h.dtype)
    elif dropout_seed is not None and self.pdrop > 0:
      h = dropout_ops.dropout(h, dropout_seed, self.site, self.pdrop,
                              self.use_kernels)
    h = self.conv2(h)
    shortcut = x if self.nin_shortcut is None else self.nin_shortcut(x)
    return shortcut + h


class AttnBlock(nn.Module):
  """Single-head self-attention over the H x W tokens, residual (the
  shipped configs use one head).

  `use_kernels` routes the attention itself through the CUDA flash kernel
  (`ops/flash_attention.py`); otherwise it runs the plain einsum version.
  """

  def __init__(self, channels: int, use_kernels: bool, remat: bool = False):
    super().__init__()
    self.use_kernels = use_kernels
    self.remat = remat
    self.GroupNormF32_0 = GroupNormF32(channels)
    self.q = Linear(channels, channels)
    self.k = Linear(channels, channels)
    self.v = Linear(channels, channels)
    self.proj_out = Linear(channels, channels)

  def forward(self, x):
    return maybe_remat(self._forward, self.remat, x)

  def _forward(self, x):
    b, c, hgt, wid = x.shape
    tokens = self.GroupNormF32_0(x).flatten(2).transpose(1, 2)  # (B, T, C)
    # (B, T, C) -> (B, 1, T, C): the attention ops' (B, heads, T, D) layout.
    q, k, v = (proj(tokens).unsqueeze(1) for proj in (self.q, self.k, self.v))
    attend = flash_attention if self.use_kernels else flash_attention_plain
    out = self.proj_out(attend(q, k, v, 1.0 / math.sqrt(c)).squeeze(1))
    return x + out.transpose(1, 2).reshape(b, c, hgt, wid)
