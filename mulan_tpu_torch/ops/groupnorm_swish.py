"""swish(groupnorm(x)) in one pass: CUDA kernel wrapper, its plain version,
and the autograd function whose backward differentiates the plain formula.

The kernel (`csrc/groupnorm_swish.cu`, K8) replaces the Pallas TPU kernel
`mulan_tpu/ops/groupnorm_swish.py:_kernel` (via `_fused_call` /
`fused_gn_swish`). The arithmetic is that module's `_gn_swish_reference`:
float32 statistics per (sample, group), the variance as E[x^2] - mean^2,
rsqrt(var + eps), the affine with the float32 weight and bias, swish in
float32 and one cast back to x's type. (The unfused `layers.GroupNormF32`
applies the affine in x's type instead, as flax does.)

Tensors are NCHW, where a group's C/G channels are one contiguous run of
C/G * H * W elements. As in JAX (`groupnorm_swish.py:123-129`), the backward
is no kernel: it differentiates the float32 formula on the saved inputs.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# A block stages its group's run in shared memory: at most 227 KB a block.
_MAX_RUN_BYTES = 232448


def _gn_swish_f32(x, weight, bias, num_groups: int, eps: float):
  """The float32 result of swish(groupnorm(x)), before the cast back."""
  b, c = x.shape[:2]
  xf = x.float().reshape(b, num_groups, -1)
  mean = xf.mean(dim=-1, keepdim=True)
  var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
  y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
  per_channel = (1, c) + (1,) * (x.dim() - 2)
  y = y * weight.float().reshape(per_channel) + bias.float().reshape(
      per_channel)
  return y * torch.sigmoid(y)


def gn_swish_plain(x, weight, bias, num_groups: int, eps: float = 1e-6):
  """swish(groupnorm(x)) for NC... x, float32 (C,) weight and bias, in
  float32 arithmetic; the output has x's type."""
  return _gn_swish_f32(x, weight, bias, num_groups, eps).to(x.dtype)


def gn_swish_fwd(x, weight, bias, num_groups: int, eps: float = 1e-6):
  """`gn_swish_plain` for CPU tensors; the K8 kernel for CUDA tensors.

  The kernel takes a contiguous NCHW float32 or bfloat16 x, contiguous
  float32 (C,) weight and bias, and C divisible by `num_groups`, and raises
  on others and on any other device.
  """
  if x.device.type == 'cpu':
    return gn_swish_plain(x, weight, bias, num_groups, eps)
  if x.device.type != 'cuda':
    raise ValueError(f'gn_swish: unsupported device {x.device}')
  if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
    raise ValueError(f'gn_swish: needs a contiguous NCHW float32 or bfloat16 '
                     f'x, got {tuple(x.shape)} {x.dtype}')
  b, c, h, w = x.shape
  for t in (weight, bias):
    if (t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
        or not t.is_contiguous()):
      raise ValueError(f'gn_swish: weight and bias must be contiguous '
                       f'float32 ({c},) on {x.device}')
  if c % num_groups:
    raise ValueError(f'gn_swish: {c} channels in {num_groups} groups')
  run_bytes = c // num_groups * h * w * x.element_size()
  if run_bytes > _MAX_RUN_BYTES:
    raise ValueError(f'gn_swish: a group of {run_bytes} bytes exceeds the '
                     f'{_MAX_RUN_BYTES} bytes of shared memory a block has')
  out = torch.empty_like(x)
  status = _build.load_library().mulan_gn_swish(
      x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c,
      h * w, num_groups, float(eps), int(x.dtype == torch.bfloat16),
      torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(status, 'gn_swish')
  gn_swish_fwd.launches += 1
  return out


gn_swish_fwd.launches = 0


class _GnSwish(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, weight, bias, num_groups, eps, use_kernel):
    ctx.save_for_backward(x, weight, bias)
    ctx.args = (num_groups, eps)
    # Looked up at call time, so that a test can substitute the forward.
    fwd = gn_swish_fwd if use_kernel else gn_swish_plain
    return fwd(x, weight, bias, num_groups, eps)

  @staticmethod
  def backward(ctx, grad):
    x, weight, bias = ctx.saved_tensors
    num_groups, eps = ctx.args
    with torch.enable_grad():
      inputs = [t.detach().requires_grad_() for t in (x, weight, bias)]
      y = _gn_swish_f32(*inputs, num_groups, eps)
      dx, dweight, dbias = torch.autograd.grad(y, inputs, grad.float())
    return dx.to(x.dtype), dweight, dbias, None, None, None


def gn_swish(x, weight, bias, num_groups: int, eps: float = 1e-6,
             use_kernel: bool = False) -> torch.Tensor:
  """swish(groupnorm(x)): with `use_kernel` through `gn_swish_fwd` (K8 for
  CUDA tensors, the plain version for CPU tensors, an error elsewhere),
  else through `gn_swish_plain`. The backward differentiates the float32
  formula on the saved inputs: dx in x's type, dweight and dbias float32.
  Without autograd (evaluation, sampling) the forward runs alone."""
  if torch.is_grad_enabled() and any(t.requires_grad
                                     for t in (x, weight, bias)):
    return _GnSwish.apply(x, weight, bias, num_groups, eps, use_kernel)
  fwd = gn_swish_fwd if use_kernel else gn_swish_plain
  return fwd(x, weight, bias, num_groups, eps)
