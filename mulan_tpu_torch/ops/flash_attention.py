"""Bidirectional attention forward: CUDA kernel wrapper and its plain version.

The kernel (`csrc/flash_attention.cu`) replaces the stock Pallas TPU
flash-attention forward that `mulan_tpu/ops/flash_bwd.py:_flash_attention`
calls. The plain version is the einsum path of
`mulan_tpu/models/layers.py:AttnBlock` (float32 logits and softmax, weights
cast to the value type before the second product); it runs for CPU tensors and
is the reference the kernel is held against on the card. In bfloat16 the
tensor-core kernel rounds the unnormalized weights exp(s - running max) to
bfloat16 where the plain version rounds the normalized ones, so the two
differ by bfloat16 rounding of the weights (relative 2^-9 each); in float32
the kernel keeps the weights in float32 and only the order of sums differs.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, sm_scale: float) -> torch.Tensor:
  """softmax(sm_scale q k^T) v in (B, H, T, D) layout."""
  logits = torch.einsum('bhqd,bhkd->bhqk', q.float() * sm_scale, k.float())
  weights = torch.softmax(logits, dim=-1)
  return torch.einsum('bhqk,bhkd->bhqd', weights.to(v.dtype), v)


def flash_attention(q, k, v, sm_scale: float) -> torch.Tensor:
  """`flash_attention_plain` for CPU tensors; the CUDA kernel otherwise.

  The kernel takes contiguous (B, H, T, D) float32 or bfloat16 tensors of
  one shape and type, with D <= 256 and D % 8 == 0, and raises on others.
  """
  if q.device.type == 'cpu':
    return flash_attention_plain(q, k, v, sm_scale)
  if q.device.type != 'cuda':
    raise ValueError(f'flash_attention: unsupported device {q.device}')
  for name, t in (('k', k), ('v', v)):
    if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
      raise ValueError(f'flash_attention: {name} {tuple(t.shape)} {t.dtype} '
                       f'{t.device} does not match q {tuple(q.shape)} '
                       f'{q.dtype} {q.device}')
  if q.dim() != 4 or q.dtype not in _DTYPES:
    raise ValueError(f'flash_attention: needs (B, H, T, D) float32 or '
                     f'bfloat16, got {tuple(q.shape)} {q.dtype}')
  b, h, t, d = q.shape
  if d > 256 or d % 8 != 0:
    raise ValueError(f'flash_attention: head_dim {d} must be <= 256 and a '
                     f'multiple of 8')
  if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
             for x in (q, k, v)):
    raise ValueError('flash_attention: q, k and v must be contiguous and '
                     '16-byte aligned')
  o = torch.empty_like(q)
  lib = _build.load_library()
  status = lib.mulan_flash_attention_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, d,
      float(sm_scale), int(q.dtype == torch.bfloat16),
      torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, 'flash_attention')
  flash_attention.launches += 1
  return o


flash_attention.launches = 0
