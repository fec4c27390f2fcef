"""Bidirectional attention: CUDA kernel wrappers, their plain versions, and
the autograd function that joins the forward and backward.

The forward kernel (`csrc/flash_attention.cu`, K1) replaces the stock Pallas
TPU flash-attention forward that `mulan_tpu/ops/flash_bwd.py:_flash_attention`
calls; the backward kernels (`csrc/flash_attention_bwd.cu`) replace that
module's `_dkv_kernel` (K2, dK and dV) and `_dq_kernel` (K3, dQ). As in JAX
(`flash_bwd.py:280-321`), the forward saves the row log-sum-exp only under
autograd, and the backward computes di = rowsum(o * dO) in PyTorch before
the two kernels.

Each kernel has two routes, one C entry point each (`<entry>_sm90`,
`<entry>_simt`), chosen here by `attention_route(dtype, head_dim)`, one rule
for K1, K2 and K3: 'sm90' (TMA-fed, warp-specialised, persistent `wgmma`
kernels on `csrc/sm90.cuh`) for bfloat16 with head_dim <= 256 (the
flagship's path at 128 and imagenet32's at 256, where each C entry point
dispatches to a kernel of its own above 128), and 'simt' for float32 at any
head_dim (on the CUDA cores). A wrapper counts each launch, its route and
shape in the recorder (`utils/tracing.py`).

The plain versions run for CPU tensors and are what the kernels are held
against on the card. The plain forward is the einsum path of
`mulan_tpu/models/layers.py:AttnBlock` (float32 logits and softmax, weights
cast to the value type before the second product). In bfloat16 the
tensor-core forward rounds the unnormalized weights exp(s - running max) to
bfloat16 where the plain version rounds the normalized ones, so the two
differ by bfloat16 rounding of the weights (relative 2^-9 each); in float32
only the order of sums differs. The plain backward and the backward kernels
both compute in float32 from the inputs.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.ops import _build
from mulan_tpu_torch.utils import tracing

_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ('sm90', 'simt')
# The largest head_dim the sm90 route takes (bfloat16 only).
_SM90_MAX_HEAD_DIM = 256


def attention_route(dtype: torch.dtype, head_dim: int) -> str:
  """The route of K1, K2 and K3 for inputs of this dtype and head_dim:
  'sm90' (tensor cores) for bfloat16 with head_dim <= 256, else 'simt'."""
  return ('sm90' if dtype == torch.bfloat16
          and head_dim <= _SM90_MAX_HEAD_DIM else 'simt')


def flash_attention_plain(q, k, v, sm_scale: float, *,
                          return_lse: bool = False):
  """softmax(sm_scale q k^T) v in (B, H, T, D) layout; with `return_lse`,
  also the float32 row log-sum-exp of the scaled logits, (B, H, T)."""
  logits = torch.einsum('bhqd,bhkd->bhqk', q.float() * sm_scale, k.float())
  weights = torch.softmax(logits, dim=-1)
  out = torch.einsum('bhqk,bhkd->bhqd', weights.to(v.dtype), v)
  if return_lse:
    return out, torch.logsumexp(logits, dim=-1)
  return out


def flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale: float):
  """(dq, dk, dv) of `flash_attention_plain` from its output o and row
  log-sum-exp, in float32 arithmetic; outputs in q's type."""
  qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
  p = torch.exp(torch.einsum('bhqd,bhkd->bhqk', qf, kf) * sm_scale
                - lse[..., None])
  di = (o.float() * dof).sum(-1, keepdim=True)
  dv = torch.einsum('bhqk,bhqd->bhkd', p, dof)
  ds = p * (torch.einsum('bhqd,bhkd->bhqk', dof, vf) - di) * sm_scale
  dq = torch.einsum('bhqk,bhkd->bhqd', ds, kf)
  dk = torch.einsum('bhqk,bhqd->bhkd', ds, qf)
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(name, q, *others):
  if q.device.type != 'cuda':
    raise ValueError(f'{name}: unsupported device {q.device}')
  for t in others:
    if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
      raise ValueError(f'{name}: {tuple(t.shape)} {t.dtype} {t.device} does '
                       f'not match q {tuple(q.shape)} {q.dtype} {q.device}')
  if q.dim() != 4 or q.dtype not in _DTYPES:
    raise ValueError(f'{name}: needs (B, H, T, D) float32 or bfloat16, got '
                     f'{tuple(q.shape)} {q.dtype}')
  d = q.shape[-1]
  if d > 256 or d % 8 != 0:
    raise ValueError(f'{name}: head_dim {d} must be <= 256 and a multiple '
                     f'of 8')
  if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
             for x in (q, *others)):
    raise ValueError(f'{name}: inputs must be contiguous and 16-byte '
                     f'aligned')


def _check_rows(name, q, *rows):
  for t in rows:
    if (t.shape != q.shape[:3] or t.dtype != torch.float32
        or t.device != q.device or not t.is_contiguous()):
      raise ValueError(f'{name}: row statistics must be contiguous float32 '
                       f'{tuple(q.shape[:3])} on {q.device}')


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _launch(entry, kernel, q, *args):
  """Calls the C entry point `{entry}_{route}` for the route at q's dtype
  and head_dim on the current stream, raises on its error, and counts the
  launch as `kernel` on its route with q's shape and dtype
  (`utils/tracing.py`). The simt entry point also takes is_bf16: 0, as the
  route is float32's (its bf16 kernels are kept to time against 'sm90')."""
  route = attention_route(q.dtype, q.shape[-1])
  if route == 'simt':
    args = (*args, 0)
  lib = _build.load_library()
  _build.check(getattr(lib, f'{entry}_{route}')(*args, _stream(q)), kernel)
  b, h, t, d = q.shape
  tracing.count(kernel, route, b=b, h=h, t=t, d=d, dtype=q.dtype)


def flash_attention_fwd(q, k, v, sm_scale: float, *,
                        return_lse: bool = False):
  """`flash_attention_plain` for CPU tensors; the K1 kernel otherwise.

  The kernel takes contiguous (B, H, T, D) float32 or bfloat16 tensors of
  one shape and type, with D <= 256 and D % 8 == 0, and raises on others.
  With `return_lse` it also writes the row log-sum-exp.
  """
  if q.device.type == 'cpu':
    return flash_attention_plain(q, k, v, sm_scale, return_lse=return_lse)
  _check_inputs('flash_attention', q, k, v)
  b, h, t, d = q.shape
  o = torch.empty_like(q)
  lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
         if return_lse else None)
  _launch('mulan_flash_attention_fwd', 'flash_attention', q,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          None if lse is None else lse.data_ptr(), b * h, t, d,
          float(sm_scale))
  return (o, lse) if return_lse else o


def flash_attention_bwd_dkv(q, k, v, do, lse, di, sm_scale: float):
  """(dk, dv) through the K2 kernel; CUDA tensors only."""
  _check_inputs('flash_attention_bwd_dkv', q, k, v, do)
  _check_rows('flash_attention_bwd_dkv', q, lse, di)
  b, h, t, d = q.shape
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  _launch('mulan_flash_attention_bwd_dkv', 'flash_attention_bwd_dkv', q,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h,
          t, d, float(sm_scale))
  return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, sm_scale: float):
  """dq through the K3 kernel; CUDA tensors only."""
  _check_inputs('flash_attention_bwd_dq', q, k, v, do)
  _check_rows('flash_attention_bwd_dq', q, lse, di)
  b, h, t, d = q.shape
  dq = torch.empty_like(q)
  _launch('mulan_flash_attention_bwd_dq', 'flash_attention_bwd_dq', q,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b * h, t, d,
          float(sm_scale))
  return dq


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float):
  """(dq, dk, dv): `flash_attention_bwd_plain` for CPU tensors; otherwise
  di = rowsum(o * do) in PyTorch, then the K2 and K3 kernels."""
  if q.device.type == 'cpu':
    return flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale)
  do = do.contiguous()
  di = (o.float() * do.float()).sum(-1)
  dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, sm_scale)
  dq = flash_attention_bwd_dq(q, k, v, do, lse, di, sm_scale)
  return dq, dk, dv


class _FlashAttention(torch.autograd.Function):

  @staticmethod
  def forward(ctx, q, k, v, sm_scale):
    o, lse = flash_attention_fwd(q, k, v, sm_scale, return_lse=True)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.sm_scale = sm_scale
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, o, lse = ctx.saved_tensors
    return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale), None)


def flash_attention(q, k, v, sm_scale: float) -> torch.Tensor:
  """softmax(sm_scale q k^T) v, (B, H, T, D): the plain versions for CPU
  tensors, the kernels for CUDA tensors, and an error on any other device.
  Under autograd the forward also saves the row log-sum-exp and the
  backward runs K2 and K3."""
  if q.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'flash_attention: unsupported device {q.device}')
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return _FlashAttention.apply(q, k, v, sm_scale)
  return flash_attention_fwd(q, k, v, sm_scale)

