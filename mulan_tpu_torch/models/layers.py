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

`GroupNormF32`, `ResnetBlock` and `AttnBlock` take a `tensor` group
(`parallel/tensor.py`; the score UNet's under `training.tp` > 1): each
then holds its slice of the output channels of every layer, takes and
returns channel-sharded activations, and gathers channels where a layer
needs them all. Without one they are the one-process blocks.
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
from mulan_tpu_torch.parallel import tensor as tensor_lib


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
  """`module`'s parameter `name` (or None) in `dtype`.

  Under autograd the cast is part of the graph, as in flax. Without autograd
  (evaluation, sampling) the cast is kept on the module and reused until the
  parameter changes: every in-place update (an optimizer step, the EMA's
  lerp, `load_state_dict`) moves its version counter and `Module.to` gives
  it new storage, and either makes the next call cast afresh. So the
  sampler's UNet passes do not recast every weight on every step. A module
  with `cache_casts = False` (every module under FSDP, whose all-gathers
  reuse storage and keep the version, `parallel/wrap.py`) always casts.
  `cast_param.casts` counts the casts made.
  """
  p = getattr(module, name)
  if p is None or p.dtype == dtype:
    return p
  if torch.is_grad_enabled() or not getattr(module, 'cache_casts', True):
    cast_param.casts += 1
    return p.to(dtype)
  key = (dtype, p.data_ptr(), p._version)
  cache = module.__dict__.setdefault('_casts', {})
  if name not in cache or cache[name][0] != key:
    cast_param.casts += 1
    cache[name] = (key, p.to(dtype))
  return cache[name][1]


cast_param.casts = 0


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


# The gamma networks' matmul precisions (`model.gamma_precision`, JAX's
# `gamma_matmul_precision`): float32 products, three bf16 passes, or one.
GAMMA_PRECISIONS = ('highest', 'high', 'default')


def _bf16(x):
  """x rounded to bf16, held in float32."""
  return x.to(torch.bfloat16).float()


def _bf16_passes(x, w, precision: str):
  """x @ w from bf16 operands with float32 accumulation: one pass
  ('default'), or the three of the bf16 splits x = hi + lo ('high':
  hi.hi + hi.lo + lo.hi, as the TPU's `Precision.HIGH` computes a float32
  product). A product of two bf16 values is exact in float32, so a float32
  matmul of bf16 values is a bf16 pass with float32 accumulation."""
  if precision == 'default':
    return _bf16(x) @ _bf16(w)
  x_hi, w_hi = _bf16(x), _bf16(w)
  x_lo, w_lo = _bf16(x - x_hi), _bf16(w - w_hi)
  return (x_hi @ w_lo + x_lo @ w_hi) + x_hi @ w_hi


class _BF16PassMatmul(torch.autograd.Function):
  """x @ w in bf16 passes, its gradients' two products in the same passes
  (as XLA differentiates a dot of a given precision)."""

  @staticmethod
  def forward(ctx, x, w, precision):
    ctx.save_for_backward(x, w)
    ctx.precision = precision
    return _bf16_passes(x, w, precision)

  @staticmethod
  def backward(ctx, grad):
    x, w = ctx.saved_tensors
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = _bf16_passes(grad, w.t(), ctx.precision)
    if ctx.needs_input_grad[1]:
      dw = _bf16_passes(x.t(), grad, ctx.precision)
    return dx, dw, None


def gamma_matmul(x, w, precision: str = 'highest'):
  """(B, in) @ (in, out) in float32 at a `GAMMA_PRECISIONS` precision:
  'highest' is the float32 matmul (TF32 off), 'high' and 'default' the
  bf16 passes of `_bf16_passes`."""
  if precision == 'highest':
    return x @ w
  if precision not in GAMMA_PRECISIONS:
    raise ValueError(f'unknown gamma_precision: {precision!r}')
  return _BF16PassMatmul.apply(x, w, precision)


class DenseMonotone(nn.Module):
  """x @ |kernel| + bias: monotone non-decreasing in its inputs
  (`mulan_tpu/models/layers.py:DenseMonotone`), the product at
  `precision` (`gamma_matmul`). The kernel keeps flax's (in, out) layout,
  so `params.from_flax` copies it as it is. float32."""

  def __init__(self, in_features: int, out_features: int,
               use_bias: bool = True, precision: str = 'highest'):
    super().__init__()
    self.kernel = nn.Parameter(torch.empty(in_features, out_features))
    self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                 else None)
    self.precision = precision

  def forward(self, x):
    y = gamma_matmul(x.float(), self.kernel.abs(), self.precision)
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
  `gn_swish(x)` is swish(groupnorm(x)) at every GroupNorm -> swish site:
  without `fused_swish` it gives F.silu(self(x)), through K8's kernels in
  the unfused arithmetic where `use_kernels` is set and x is not on the
  CPU (the same bits in the forward; the wrappers raise on what the
  kernels do not take).

  With a `tensor` group, x is this rank's channels of the C global ones
  (in `segments` equal parts, each this rank's slice of a part: the up
  blocks' [h, skip]) and so are the parameters. Where every part's slice
  holds whole groups (C / 32 channels a group at C >= 32: every tp that
  divides 32, 16 for the up blocks' [h, skip]), it normalizes them alone,
  the rank's groups being whole groups of the global tensor. Otherwise it
  gathers the channels and the parameters, normalizes them whole on every
  rank (through `gn_swish`, K8 with `use_kernels`, in the fused or the
  unfused arithmetic) and keeps its own channels.
  """

  def __init__(self, channels: int, fused_swish: bool = False,
               use_kernels: bool = False, tensor=None, segments: int = 1):
    super().__init__()
    groups = math.gcd(channels, 32)
    self.fused_swish = fused_swish
    self.use_kernels = use_kernels
    self.tensor, self.segments = tensor, segments
    local = tensor_lib.part(channels, tensor)
    # The groups of one part's slice are whole groups of the global tensor.
    self.gathered = (local // segments) % (channels // groups) != 0
    self.num_groups = groups if self.gathered else (
        groups * local // channels)
    self.weight = nn.Parameter(torch.ones(local))
    self.bias = nn.Parameter(torch.zeros(local))

  def forward(self, x):
    if self.gathered:
      return self._gathered(x, 'fused' if self.fused_swish else None)
    if self.fused_swish:
      return gn_ops.gn_swish(x, self.weight, self.bias, self.num_groups, 1e-6,
                             self.use_kernels)
    return F.group_norm(x, self.num_groups,
                        cast_param(self, 'weight', x.dtype),
                        cast_param(self, 'bias', x.dtype), 1e-6)

  def gn_swish(self, x):
    """swish(groupnorm(x)): `self(x)` with `fused_swish`; else
    F.silu(self(x)), which K8's kernels compute in the unfused arithmetic
    (`gn_swish(..., arithmetic='unfused')`: the same forward bits, the
    backward's sums in float32) where `use_kernels` is set and x is not
    on the CPU, gathered or not. Like the attention block, such a site
    never falls back to the library: the wrappers raise on a device,
    layout, type or group run the kernels do not take."""
    if self.fused_swish:
      return self(x)
    if not self.use_kernels or x.device.type == 'cpu':
      return F.silu(self(x))
    if self.gathered:
      return self._gathered(x, 'unfused')
    return gn_ops.gn_swish(x, self.weight, self.bias, self.num_groups, 1e-6,
                           True, 'unfused')

  def _gathered(self, x, arithmetic):
    """The rank's channels of the whole tensor's groupnorm (`arithmetic`
    None) or of its swish in that arithmetic: every rank normalizes the
    gathered channels with the gathered parameters. The input's gradient
    is partial on each rank (the group statistics mix the channels), so
    its gather sums; the parameters' is the rank's channels' alone, so
    theirs keeps the slice."""
    whole = tensor_lib.gather(x, self.tensor, 1, self.segments)
    weight, bias = (tensor_lib.gather(p, self.tensor, 0, self.segments,
                                      grad='slice')
                    for p in (self.weight, self.bias))
    if arithmetic is None:
      y = F.group_norm(whole, self.num_groups, weight.to(x.dtype),
                       bias.to(x.dtype), 1e-6)
    else:
      y = gn_ops.gn_swish(whole, weight, bias, self.num_groups, 1e-6,
                          self.use_kernels, arithmetic)
    return tensor_lib.take(y, self.tensor, 1, self.segments)


class ResnetBlock(nn.Module):
  """GN-swish-conv3x3 (+ projected conditioning) GN-swish-dropout-conv3x3,
  plus a 1x1 `nin_shortcut` when the channel count changes. The
  conditioning is one vector an example (B, D), added over all pixels, or
  a map (B, H, W, D) projected and added pixel by pixel
  (`mulan_tpu/models/layers.py:187-195`).

  Dropout runs only when `forward` gets a `dropout_seed`: the mask is keyed
  by (dropout_seed, site), `site` being the block's fixed index in its
  model, and comes from the K6 kernel when `use_kernels` is set
  (`ops/dropout.py`); x holds rows `dropout_row` on of the global batch,
  whose mask rows it takes. An explicit pre-scaled `dropout_mask` (NCHW, shaped
  like the activation) replaces it, as the JAX block's `dropout_mask`
  argument does; the product saves it for the backward.

  `fused_gn` computes both GN-swish sites in one pass each
  (`GroupNormF32(fused_swish=True)`, K8 with `use_kernels`); without it
  the sites run `GroupNormF32.gn_swish` (K8 in the unfused arithmetic
  with `use_kernels` on the card).

  With a `tensor` group (column parallel): x is the rank's channels of the
  input (in `in_segments` parts, `GroupNormF32`'s), the conditioning whole;
  the GN-swish sites run on the rank's channels, conv1, conv2 and
  `nin_shortcut` on the gathered channels to the rank's output slice,
  `cond_proj` to the rank's slice, and the dropout mask is the rank's
  channel window of the site's global mask. The output is the rank's
  channels.
  """

  def __init__(self, in_ch: int, out_ch: int, cond_dim: int, *,
               pdrop: float = 0.0, site: int = 0, use_kernels: bool = False,
               fused_gn: bool = False, remat: bool = False, tensor=None,
               in_segments: int = 1):
    super().__init__()
    self.pdrop = pdrop
    self.site = site
    self.use_kernels = use_kernels
    self.fused_gn = fused_gn
    self.remat = remat
    self.tensor, self.in_segments = tensor, in_segments
    self.out_ch = out_ch
    out_local = tensor_lib.part(out_ch, tensor)
    self.GroupNormF32_0 = GroupNormF32(in_ch, fused_gn, use_kernels, tensor,
                                       in_segments)
    self.conv1 = Conv2d(in_ch, out_local, 3, padding=1)
    self.cond_proj = Linear(cond_dim, out_local, bias=False)
    self.GroupNormF32_1 = GroupNormF32(out_ch, fused_gn, use_kernels, tensor)
    self.conv2 = Conv2d(out_ch, out_local, 3, padding=1)
    self.nin_shortcut = (Conv2d(in_ch, out_local, 1) if in_ch != out_ch
                         else None)

  def _gather(self, h, segments: int = 1):
    return tensor_lib.gather(h, self.tensor, 1, segments)

  def forward(self, x, cond, dropout_seed=None, dropout_mask=None,
              dropout_row: int = 0):
    return maybe_remat(self._forward, self.remat, x, cond, dropout_seed,
                       dropout_mask, dropout_row)

  def _forward(self, x, cond, dropout_seed, dropout_mask, dropout_row):
    h = self.conv1(self._gather(self.GroupNormF32_0.gn_swish(x),
                                self.in_segments))
    proj = self.cond_proj(cond)
    if cond.dim() == 2:  # (B, D): broadcast over H, W
      h = h + proj[:, :, None, None]
    else:  # (B, H, W, D): a bias per pixel (the 'ldm' UNet)
      h = h + proj.permute(0, 3, 1, 2)
    h = self.GroupNormF32_1.gn_swish(h)
    if dropout_mask is not None:
      h = h * dropout_mask.to(h.dtype)
    elif dropout_seed is not None and self.pdrop > 0:
      h = dropout_ops.dropout(
          h, dropout_seed, self.site, self.pdrop, self.use_kernels,
          dropout_row, None if self.tensor is None else self.tensor.window(
              self.out_ch))
    h = self.conv2(self._gather(h))
    shortcut = x if self.nin_shortcut is None else self.nin_shortcut(
        self._gather(x, self.in_segments))
    return shortcut + h


class AttnBlock(nn.Module):
  """Single-head self-attention over the H x W tokens, residual (the
  shipped configs use one head).

  `use_kernels` routes the attention itself through the CUDA flash kernel
  (`ops/flash_attention.py`); otherwise it runs the plain einsum version.

  With a `tensor` group: x and the output are the rank's channels; the
  GroupNorm runs on them, q, k and v project the gathered tokens to the
  rank's slice, and are gathered whole (one head: head_dim is every
  channel), so that every rank runs the attention (K1-K3) at the shapes
  one process runs; `proj_out` projects its output to the rank's slice.
  """

  def __init__(self, channels: int, use_kernels: bool, remat: bool = False,
               tensor=None):
    super().__init__()
    self.use_kernels = use_kernels
    self.remat = remat
    self.tensor = tensor
    local = tensor_lib.part(channels, tensor)
    self.GroupNormF32_0 = GroupNormF32(channels, tensor=tensor)
    self.q = Linear(channels, local)
    self.k = Linear(channels, local)
    self.v = Linear(channels, local)
    self.proj_out = Linear(channels, local)

  def forward(self, x):
    return maybe_remat(self._forward, self.remat, x)

  def _forward(self, x):
    b, c, hgt, wid = x.shape
    # (B, T, C) tokens, a transposed view of the (gathered) NCHW channels.
    tokens = tensor_lib.gather(self.GroupNormF32_0(x), self.tensor, 1)
    tokens = tokens.flatten(2).transpose(1, 2)
    q, k, v = (proj(tokens) for proj in (self.q, self.k, self.v))
    if self.tensor is not None:
      q, k, v = tensor_lib.gather(torch.stack([q, k, v]), self.tensor, -1,
                                  grad='slice').unbind(0)
    # (B, T, C) -> (B, 1, T, C): the attention ops' (B, heads, T, D) layout.
    q, k, v = (t.unsqueeze(1) for t in (q, k, v))
    attend = flash_attention if self.use_kernels else flash_attention_plain
    out = attend(q, k, v, 1.0 / math.sqrt(q.shape[-1])).squeeze(1)
    out = self.proj_out(tensor_lib.enter(out, self.tensor))
    return x + out.transpose(1, 2).reshape(b, c, hgt, wid)
