"""swish(groupnorm(x)) in one pass: the CUDA kernels of its forward and
backward, their plain versions, and the autograd function that joins them.

The forward kernel (`csrc/groupnorm_swish.cu`, K8) replaces the Pallas TPU
kernel `mulan_tpu/ops/groupnorm_swish.py:_kernel` (via `_fused_call` /
`fused_gn_swish`). The arithmetic is that module's `_gn_swish_reference`:
float32 statistics per (sample, group), the variance as E[x^2] - mean^2,
rsqrt(var + eps), the affine with the float32 weight and bias, swish in
float32 and one cast back to x's type.

The same kernels run a second arithmetic, 'unfused': the bits of
F.silu(F.group_norm(x, G, w.to(x.dtype), b.to(x.dtype), eps)) as PyTorch's
CUDA kernels compute them, for the model's unfused GroupNorm -> swish sites
(`layers.GroupNormF32.gn_swish`). PyTorch reduces each (sample, group) in
float32 by Welford and keeps the mean and rsqrt(var + eps) in x's type
(eps cast to it too); it folds the affine per channel into a = rstd w and
b' = b - mean a in float32 from the parameters and statistics in x's type
and writes y = a x + b' in x's type; silu computes y / (1 + exp(-y)) in
float32 and rounds again. The backward recomputes that rounded y and keeps
g and every sum in float32 (autograd rounds silu's gradient to x's type).

The backward kernel (the same file) replaces the vjp that JAX's `_bwd`
(`groupnorm_swish.py:123-131`) takes of that formula, which XLA fuses on the
TPU; `gn_swish_bwd_plain` is its closed form in PyTorch. Tensors are NCHW,
where a group's C/G channels are one contiguous run of C/G * H * W elements.
Under autograd the forward also writes each (sample, group)'s mean and
rstd, and the backward takes them instead of reducing x again. The backward
has two designs, chosen by shape (`bwd_design`): a persistent ring of bulk
copies for runs of 16-byte vectors, and one block a run in registers for
the others.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.ops import _build
from mulan_tpu_torch.utils import tracing

_DTYPES = (torch.float32, torch.bfloat16)
ARITHMETICS = ('fused', 'unfused')
# A kernel's block holds its group's run in registers: at most 16 vectors of
# 16 bytes (of single elements, where H x W is no multiple of a vector) for
# each of its 256 threads.
_MAX_RUN_VECTORS = 16 * 256
# The backward's ring holds two runs of x and dy in shared memory, two
# vectors for each of at most 1,024 threads.
_RING_RUN_VECTORS = 2 * 1024
# Arrival counters of the backward, by (device, stream): zeros that every
# launch leaves zero.
_COUNTERS = {}


def group_stats(x, num_groups: int, eps: float, arithmetic: str = 'fused'):
  """(B, G, 2) float32: each (sample, group)'s mean and rsqrt(var + eps),
  as K8's forward writes them. 'fused': var = E[x^2] - mean^2. 'unfused':
  var the mean of the squares about the mean, and eps, the mean and rstd
  rounded to x's type, as PyTorch's GroupNorm keeps them."""
  _check_arithmetic(arithmetic)
  xf = x.float().reshape(x.shape[0], num_groups, -1)
  mean = xf.mean(dim=-1)
  if arithmetic == 'fused':
    var = (xf * xf).mean(dim=-1) - mean * mean
    return torch.stack((mean, torch.rsqrt(var + eps)), dim=-1)
  var = (xf - mean[..., None]).square().mean(dim=-1)
  eps = torch.tensor(eps, dtype=x.dtype).item()
  return torch.stack((mean, torch.rsqrt(var + eps)), dim=-1).to(
      x.dtype).float()


def _check_arithmetic(arithmetic: str) -> None:
  if arithmetic not in ARITHMETICS:
    raise ValueError(f'arithmetic {arithmetic!r}: one of {ARITHMETICS}')


def _normalized(x, num_groups: int, eps: float, stats=None):
  """(xhat, rstd): x normalized per (sample, group) in float32, shaped like
  x, and rsqrt(var + eps) shaped (B, G, 1), from `stats` (`group_stats`'s
  layout) where given, else from x."""
  if stats is None:
    stats = group_stats(x, num_groups, eps)
  xf = x.float().reshape(x.shape[0], num_groups, -1)
  mean, rstd = stats[..., :1], stats[..., 1:]
  return ((xf - mean) * rstd).reshape(x.shape), rstd


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _per_channel(t, x):
  return t.float().reshape((1, x.shape[1]) + (1,) * (x.dim() - 2))


def _pre_swish(x, weight, bias, num_groups: int, stats, arithmetic: str):
  """(y, xhat, rstd, w): swish's input y in float32, x normalized, rstd
  (`_normalized`'s) and the weight as the arithmetic reads it, per channel.
  'fused': y = xhat w + b, the float32 weight and bias. 'unfused': the
  group_norm output, x a + b' with a = rstd w and b' = b - mean a from the
  weight and bias rounded to x's type, rounded to x's type."""
  xhat, rstd = _normalized(x, num_groups, 0.0, stats)
  if arithmetic == 'fused':
    w = _per_channel(weight, x)
    return xhat * w + _per_channel(bias, x), xhat, rstd, w
  w, b = (_per_channel(t.to(x.dtype), x) for t in (weight, bias))
  per_channel = stats.repeat_interleave(x.shape[1] // num_groups, dim=1)
  mean, r = (per_channel[..., i].reshape(x.shape[:2] + (1,) * (x.dim() - 2))
             for i in (0, 1))
  a = r * w
  y = (x.float() * a + (b - mean * a)).to(x.dtype).float()
  return y, xhat, rstd, w


def gn_swish_plain(x, weight, bias, num_groups: int, eps: float = 1e-6,
                   stats: bool = False, arithmetic: str = 'fused'):
  """swish(groupnorm(x)) for NC... x, float32 (C,) weight and bias, in
  float32 arithmetic ('fused', K8's) or in the unfused path's
  ('unfused': the module header); the output has x's type. With `stats`,
  (output, `group_stats`)."""
  st = group_stats(x, num_groups, eps, arithmetic)
  y, *_ = _pre_swish(x, weight, bias, num_groups, st, arithmetic)
  out = (y * torch.sigmoid(y) if arithmetic == 'fused'
         else y / (1 + torch.exp(-y))).to(x.dtype)
  return (out, st) if stats else out


def gn_swish_bwd_plain(x, weight, bias, dy, num_groups: int,
                       eps: float = 1e-6, stats=None,
                       arithmetic: str = 'fused'):
  """(dx, dweight, dbias) of `gn_swish_plain` for the output cotangent dy,
  in closed form in float32: with y swish's input (`_pre_swish`: xhat w + b,
  or the unfused path's rounded group_norm output) and s = sigmoid(y),
  g = dy s (1 + y (1 - s)), dbias = sum g, dweight = sum g xhat over the
  batch and pixels, and dx = rstd (w g - mean_grp(w g) - xhat mean_grp(w g
  xhat)) with the means over each (sample, group), from the forward's
  `stats` where given. dx has x's type, dweight and dbias are float32."""
  if stats is None:
    stats = group_stats(x, num_groups, eps, arithmetic)
  y, xhat, rstd, w = _pre_swish(x, weight, bias, num_groups, stats,
                                arithmetic)
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
  whose group runs fit a block, with contiguous float32 (C,) params. The
  device is checked last, so that what else it refuses shows anywhere."""
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
  if x.device.type != 'cuda':
    raise ValueError(f'{what}: unsupported device {x.device}')


def gn_swish_fwd(x, weight, bias, num_groups: int, eps: float = 1e-6,
                 stats: bool = False, arithmetic: str = 'fused'):
  """`gn_swish_plain` for CPU tensors; the K8 kernel for CUDA tensors, in
  the `arithmetic` given. With `stats`, (output, (B, G, 2) float32 mean and
  rstd), which the kernel writes beside its output.

  The kernel takes a contiguous NCHW float32 or bfloat16 x, contiguous
  float32 (C,) weight and bias, and C divisible by `num_groups`, and raises
  on others and on any other device.
  """
  _check_arithmetic(arithmetic)
  if x.device.type == 'cpu':
    return gn_swish_plain(x, weight, bias, num_groups, eps, stats,
                          arithmetic)
  _check_args('gn_swish', x, num_groups, weight, bias)
  b, c, h, w = x.shape
  out = torch.empty_like(x)
  st = torch.empty((b, num_groups, 2), dtype=torch.float32,
                   device=x.device) if stats else None
  status = _build.load_library().mulan_gn_swish(
      x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
      None if st is None else st.data_ptr(), b, c, h * w, num_groups,
      float(eps), int(x.dtype == torch.bfloat16),
      int(arithmetic == 'unfused'), _stream(x))
  _build.check(status, 'gn_swish')
  tracing.count('gn_swish', elements=x.numel(), dtype=x.dtype,
                arithmetic=arithmetic)
  return (out, st) if stats else out


def bwd_design(shape, dtype, num_groups: int, aligned: bool = True) -> str:
  """The backward kernel that takes a (B, C, H, W) x of `dtype`: 'ring'
  (`mulan_gn_swish_bwd`: persistent, bulk copies into a shared-memory ring)
  where H x W is a multiple of a 16-byte vector, x and dy are 16-byte
  aligned (`aligned`) and a group's run is at most 2,048 vectors;
  else 'regs' (`mulan_gn_swish_bwd_regs`: a block a run, in registers)."""
  _, c, h, w = shape
  per_vector = 16 // dtype.itemsize
  if not aligned or h * w % per_vector:
    return 'regs'
  return ('ring' if c // num_groups * h * w <= per_vector * _RING_RUN_VECTORS
          else 'regs')


def _counters(device, stream, num_groups: int):
  """The backward's per-group arrival counters for launches on `stream`
  (a `cuda_stream` handle) of `device`: int32 zeros, which every launch
  leaves zero (so none needs a memset)."""
  key = (device.index, stream)
  counters = _COUNTERS.get(key)
  if counters is None or counters.numel() < num_groups:
    counters = torch.zeros(max(num_groups, 32), dtype=torch.int32,
                           device=device)
    _COUNTERS[key] = counters
  return counters


def gn_swish_bwd(x, weight, bias, dy, num_groups: int, eps: float = 1e-6,
                 stats=None, arithmetic: str = 'fused'):
  """`gn_swish_bwd_plain` for CPU tensors; for CUDA tensors K8's backward,
  one launch that also sums dweight and dbias over the batch in a fixed
  order, with dy of x's shape, type and layout and the forward's `stats`
  ((B, G, 2) float32, which the kernel needs, written in the same
  `arithmetic`), through the design `bwd_design` picks. Raises on what the
  kernels do not take and on any other device."""
  _check_arithmetic(arithmetic)
  if x.device.type == 'cpu':
    return gn_swish_bwd_plain(x, weight, bias, dy, num_groups, eps, stats,
                              arithmetic)
  _check_args('gn_swish_bwd', x, num_groups, weight, bias)
  if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
      or not dy.is_contiguous():
    raise ValueError(f'gn_swish_bwd: dy must be a contiguous '
                     f'{tuple(x.shape)} {x.dtype} tensor on {x.device}')
  b, c, h, w = x.shape
  if stats is None or (
      stats.shape != (b, num_groups, 2) or stats.dtype != torch.float32
      or stats.device != x.device or not stats.is_contiguous()):
    raise ValueError(f'gn_swish_bwd: needs the forward\'s stats, contiguous '
                     f'float32 ({b}, {num_groups}, 2) on {x.device}')
  design = bwd_design(
      x.shape, x.dtype, num_groups,
      aligned=x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
  lib = _build.load_library()
  entry = (lib.mulan_gn_swish_bwd if design == 'ring'
           else lib.mulan_gn_swish_bwd_regs)
  stream = _stream(x)
  dx = torch.empty_like(x)
  partial = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
  dweight, dbias = torch.empty((2, c), dtype=torch.float32, device=x.device)
  status = entry(
      x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
      stats.data_ptr(), dx.data_ptr(), partial.data_ptr(),
      _counters(x.device, stream, num_groups).data_ptr(), dweight.data_ptr(),
      dbias.data_ptr(), b, c, h * w, num_groups,
      int(x.dtype == torch.bfloat16), int(arithmetic == 'unfused'), stream)
  _build.check(status, f'gn_swish_bwd ({design})')
  tracing.count('gn_swish_bwd', design, elements=x.numel(), dtype=x.dtype,
                arithmetic=arithmetic)
  return dx, dweight, dbias


class _GnSwish(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, weight, bias, num_groups, eps, use_kernel, arithmetic):
    ctx.args = (num_groups, eps)
    ctx.use_kernel, ctx.arithmetic = use_kernel, arithmetic
    # Looked up at call time, so that a test can substitute either one.
    fwd = gn_swish_fwd if use_kernel else gn_swish_plain
    out, stats = fwd(x, weight, bias, num_groups, eps, True, arithmetic)
    ctx.save_for_backward(x, weight, bias, stats)
    return out

  @staticmethod
  def backward(ctx, grad):
    x, weight, bias, stats = ctx.saved_tensors
    bwd = gn_swish_bwd if ctx.use_kernel else gn_swish_bwd_plain
    dx, dweight, dbias = bwd(x, weight, bias, grad.contiguous(), *ctx.args,
                             stats, ctx.arithmetic)
    return dx, dweight, dbias, None, None, None, None


def gn_swish(x, weight, bias, num_groups: int, eps: float = 1e-6,
             use_kernel: bool = False,
             arithmetic: str = 'fused') -> torch.Tensor:
  """swish(groupnorm(x)) in the `arithmetic` given (`ARITHMETICS`): with
  `use_kernel` through `gn_swish_fwd` (K8 for CUDA tensors, the plain
  version for CPU tensors, an error elsewhere), else through
  `gn_swish_plain`; the backward likewise through `gn_swish_bwd` or
  `gn_swish_bwd_plain`, on the saved inputs and the forward's statistics:
  dx in x's type, dweight and dbias float32. Without autograd (evaluation,
  sampling) the forward runs alone and writes no statistics."""
  if torch.is_grad_enabled() and any(t.requires_grad
                                     for t in (x, weight, bias)):
    return _GnSwish.apply(x, weight, bias, num_groups, eps, use_kernel,
                          arithmetic)
  fwd = gn_swish_fwd if use_kernel else gn_swish_plain
  return fwd(x, weight, bias, num_groups, eps, False, arithmetic)
