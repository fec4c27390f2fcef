"""swish(groupnorm(x)) in one pass: the CUDA kernels of its forward and
backward, their plain versions, and the autograd function that joins them.

The forward kernel (`csrc/groupnorm_swish.cu`, K8) replaces the Pallas TPU
kernel `mulan_tpu/ops/groupnorm_swish.py:_kernel` (via `_fused_call` /
`fused_gn_swish`). The arithmetic is that module's `_gn_swish_reference`:
float32 statistics per (sample, group), the variance as E[x^2] - mean^2,
rsqrt(var + eps), the affine with the float32 weight and bias, swish in
float32 and one cast back to x's type. (The unfused `layers.GroupNormF32`
applies the affine in x's type instead, as flax does.)

The backward kernel (the same file) replaces the vjp that JAX's `_bwd`
(`groupnorm_swish.py:123-131`) takes of that formula, which XLA fuses on the
TPU; `gn_swish_bwd_plain` is its closed form in PyTorch. Tensors are NCHW,
where a group's C/G channels are one contiguous run of C/G * H * W elements.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# A kernel's block holds its group's run in registers: at most 16 vectors of
# 16 bytes (of single elements, where H x W is no multiple of a vector) for
# each of its 256 threads.
_MAX_RUN_VECTORS = 16 * 256


def _normalized(x, num_groups: int, eps: float):
  """(xhat, rstd): x normalized per (sample, group) in float32, shaped like
  x, and rsqrt(var + eps) shaped (B, G, 1)."""
  b = x.shape[0]
  xf = x.float().reshape(b, num_groups, -1)
  mean = xf.mean(dim=-1, keepdim=True)
  var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
  rstd = torch.rsqrt(var + eps)
  return ((xf - mean) * rstd).reshape(x.shape), rstd


def _per_channel(t, x):
  return t.float().reshape((1, x.shape[1]) + (1,) * (x.dim() - 2))


def gn_swish_plain(x, weight, bias, num_groups: int, eps: float = 1e-6):
  """swish(groupnorm(x)) for NC... x, float32 (C,) weight and bias, in
  float32 arithmetic; the output has x's type."""
  xhat, _ = _normalized(x, num_groups, eps)
  y = xhat * _per_channel(weight, x) + _per_channel(bias, x)
  return (y * torch.sigmoid(y)).to(x.dtype)


def gn_swish_bwd_plain(x, weight, bias, dy, num_groups: int,
                       eps: float = 1e-6):
  """(dx, dweight, dbias) of `gn_swish_plain` for the output cotangent dy,
  in closed form in float32: with y = xhat w + b and s = sigmoid(y),
  g = dy s (1 + y (1 - s)), dbias = sum g, dweight = sum g xhat over the
  batch and pixels, and dx = rstd (w g - mean_grp(w g) - xhat mean_grp(w g
  xhat)) with the means over each (sample, group). dx has x's type, dweight
  and dbias are float32."""
  xhat, rstd = _normalized(x, num_groups, eps)
  w = _per_channel(weight, x)
  y = xhat * w + _per_channel(bias, x)
  s = torch.sigmoid(y)
  g = dy.float() * s * (1 + y * (1 - s))
  dims = (0,) + tuple(range(2, x.dim()))
  dweight, dbias = (g * xhat).sum(dims), g.sum(dims)
  b = x.shape[0]
  wg = (w * g).reshape(b, num_groups, -1)
  xg = xhat.reshape(b, num_groups, -1)
  dx = rstd * (wg - wg.mean(dim=-1, keepdim=True)
               - xg * (wg * xg).mean(dim=-1, keepdim=True))
  return dx.reshape(x.shape).to(x.dtype), dweight, dbias


def _check_args(what, x, num_groups, *params):
  """Raises unless x is a contiguous NCHW float32 or bfloat16 CUDA tensor
  whose group runs fit a block, with contiguous float32 (C,) params."""
  if x.device.type != 'cuda':
    raise ValueError(f'{what}: unsupported device {x.device}')
  if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
    raise ValueError(f'{what}: needs a contiguous NCHW float32 or bfloat16 '
                     f'x, got {tuple(x.shape)} {x.dtype}')
  b, c, h, w = x.shape
  for t in params:
    if (t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
        or not t.is_contiguous()):
      raise ValueError(f'{what}: weight and bias must be contiguous '
                       f'float32 ({c},) on {x.device}')
  if c % num_groups:
    raise ValueError(f'{what}: {c} channels in {num_groups} groups')
  per_vector = 16 // x.element_size() if h * w * x.element_size() % 16 == 0 \
      else 1
  if c // num_groups * h * w > per_vector * _MAX_RUN_VECTORS:
    raise ValueError(f'{what}: a group of {c // num_groups * h * w} elements '
                     f'exceeds the {per_vector * _MAX_RUN_VECTORS} a block '
                     f'holds')


def gn_swish_fwd(x, weight, bias, num_groups: int, eps: float = 1e-6):
  """`gn_swish_plain` for CPU tensors; the K8 kernel for CUDA tensors.

  The kernel takes a contiguous NCHW float32 or bfloat16 x, contiguous
  float32 (C,) weight and bias, and C divisible by `num_groups`, and raises
  on others and on any other device.
  """
  if x.device.type == 'cpu':
    return gn_swish_plain(x, weight, bias, num_groups, eps)
  _check_args('gn_swish', x, num_groups, weight, bias)
  b, c, h, w = x.shape
  out = torch.empty_like(x)
  status = _build.load_library().mulan_gn_swish(
      x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c,
      h * w, num_groups, float(eps), int(x.dtype == torch.bfloat16),
      torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(status, 'gn_swish')
  gn_swish_fwd.launches += 1
  return out


def gn_swish_bwd(x, weight, bias, dy, num_groups: int, eps: float = 1e-6):
  """`gn_swish_bwd_plain` for CPU tensors; the K8 backward kernel (and its
  fixed-order sum of the per-sample partials) for CUDA tensors, with dy of
  x's shape, type and layout. Raises on what the kernels do not take and on
  any other device."""
  if x.device.type == 'cpu':
    return gn_swish_bwd_plain(x, weight, bias, dy, num_groups, eps)
  _check_args('gn_swish_bwd', x, num_groups, weight, bias)
  if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
      or not dy.is_contiguous():
    raise ValueError(f'gn_swish_bwd: dy must be a contiguous '
                     f'{tuple(x.shape)} {x.dtype} tensor on {x.device}')
  b, c, h, w = x.shape
  dx = torch.empty_like(x)
  partial = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
  dweight = torch.empty((c,), dtype=torch.float32, device=x.device)
  dbias = torch.empty_like(dweight)
  status = _build.load_library().mulan_gn_swish_bwd(
      x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
      dx.data_ptr(), partial.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
      b, c, h * w, num_groups, float(eps), int(x.dtype == torch.bfloat16),
      torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(status, 'gn_swish_bwd')
  gn_swish_bwd.launches += 1
  return dx, dweight, dbias


gn_swish_fwd.launches = 0
gn_swish_bwd.launches = 0


class _GnSwish(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, weight, bias, num_groups, eps, use_kernel):
    ctx.save_for_backward(x, weight, bias)
    ctx.args = (num_groups, eps)
    ctx.use_kernel = use_kernel
    # Looked up at call time, so that a test can substitute either one.
    fwd = gn_swish_fwd if use_kernel else gn_swish_plain
    return fwd(x, weight, bias, num_groups, eps)

  @staticmethod
  def backward(ctx, grad):
    x, weight, bias = ctx.saved_tensors
    bwd = gn_swish_bwd if ctx.use_kernel else gn_swish_bwd_plain
    dx, dweight, dbias = bwd(x, weight, bias, grad.contiguous(), *ctx.args)
    return dx, dweight, dbias, None, None, None


def gn_swish(x, weight, bias, num_groups: int, eps: float = 1e-6,
             use_kernel: bool = False) -> torch.Tensor:
  """swish(groupnorm(x)): with `use_kernel` through `gn_swish_fwd` (K8 for
  CUDA tensors, the plain version for CPU tensors, an error elsewhere),
  else through `gn_swish_plain`; the backward likewise through
  `gn_swish_bwd` or `gn_swish_bwd_plain`, on the saved inputs: dx in x's
  type, dweight and dbias float32. Without autograd (evaluation, sampling)
  the forward runs alone."""
  if torch.is_grad_enabled() and any(t.requires_grad
                                     for t in (x, weight, bias)):
    return _GnSwish.apply(x, weight, bias, num_groups, eps, use_kernel)
  fwd = gn_swish_fwd if use_kernel else gn_swish_plain
  return fwd(x, weight, bias, num_groups, eps)
