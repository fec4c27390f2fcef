"""Decoder log-likelihood: CUDA kernel wrappers, their plain versions, and
the autograd function that joins them.

log p(x | z, g0) = sum over pixels of [l_x - logsumexp_v l_v], with
l_v = -0.5 ((z - e_v) exp(-g0/2))^2 and e_v = 2 (v + 1/2) / vocab - 1.

The kernels (`csrc/decoder_logprob.cu`) replace the Pallas TPU kernels of
`mulan_tpu/ops/decoder_logprob.py`: `_fwd_kernel` (K4, via `_run_fwd`) and
`_bwd_kernel` (K5, via `_bwd`), whose closed-form backward needs only the
softmax moments E_p[e_v] and E_p[(z - e_v)^2]. K4 sums the logsumexp only
over `logsumexp_window`, the bins whose terms a float32 exp does not flush
to 0. The plain forward streams the normalizer over vocab chunks as
`mulan_tpu/models/encdec.py:logprob` does; the plain backward is the same
closed form in PyTorch. They run for CPU tensors and are what the kernels
are held against on the card.
"""

from __future__ import annotations

import math

import torch

from mulan_tpu_torch.ops import _build


def encode(x: torch.Tensor, vocab_size: int) -> torch.Tensor:
  """Map discrete values {0..vocab-1} to centred bins in (-1, 1)."""
  x = torch.round(x.float())
  return 2.0 * ((x + 0.5) / vocab_size) - 1.0


# A term of the logsumexp at |z - e_v| e^(-g0/2) >= this sits below e^-104
# relative to the largest one, below float32's smallest denormal.
WINDOW_SIGMAS = 14.5


def logsumexp_window(z, g0, vocab_size: int = 256):
  """(first, last): the bins, inclusive, outside of which every term of
  logsumexp_v l_v is below e^-104 times the largest, as K4 computes them.
  The largest is at the bin nearest z, v*; a bin k places from it has
  l_v - l_{v*} <= -k (k - 1) / 2 (2 / vocab)^2 e^-g0, below -104 for k above
  ceil(14.5 e^(g0/2) vocab / 2) + 1."""
  half_bins = vocab_size / 2
  v_star = torch.clamp(torch.round((z + 1) * half_bins - 0.5), 0,
                       vocab_size - 1)
  half = torch.ceil(WINDOW_SIGMAS * torch.exp(0.5 * g0) * half_bins) + 1
  return (torch.clamp(v_star - half, min=0),
          torch.clamp(v_star + half, max=vocab_size - 1))


# Vocab values per step of the plain version's streamed normalizer.
_CHUNK = 64


def decoder_logprob_plain(x, z, g0, vocab_size: int = 256) -> torch.Tensor:
  """Summed per-pixel log-likelihood, shape (B,); g0 broadcasts to z."""
  chunk = min(_CHUNK, vocab_size)
  assert vocab_size % chunk == 0
  z = z.float()
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  inv_stdev = torch.exp(-0.5 * torch.broadcast_to(g0, z.shape))
  logit_x = -0.5 * torch.square((z - encode(x, vocab_size)) * inv_stdev)

  vals = encode(torch.arange(vocab_size, device=z.device), vocab_size)
  m = torch.full(z.shape, -math.inf, device=z.device)
  s = torch.zeros(z.shape, device=z.device)
  for lo in range(0, vocab_size, chunk):
    l = -0.5 * torch.square(
        (z[..., None] - vals[lo:lo + chunk]) * inv_stdev[..., None])
    m_new = torch.maximum(m, l.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(l - m_new[..., None]).sum(-1)
    m = m_new
  per_pixel = logit_x - (m + torch.log(s))
  return per_pixel.flatten(1).sum(dim=1)


def decoder_logprob_bwd_plain(x, z, g0, ct, vocab_size: int = 256):
  """(dz, dg0) of `decoder_logprob_plain` for per-pixel g0 shaped like z
  and the per-example cotangent ct (B,):
  dz = ct e^-g0 (e_x - E_p[e_v]), dg0 = ct e^-g0 ((z - e_x)^2 -
  E_p[(z - e_v)^2]) / 2, with p_v = softmax_v l_v."""
  chunk = min(_CHUNK, vocab_size)
  z = z.float()
  g0 = g0.float()
  inv_var = torch.exp(-g0)
  inv_stdev = torch.exp(-0.5 * g0)
  e_x = encode(x, vocab_size)
  vals = encode(torch.arange(vocab_size, device=z.device), vocab_size)
  m = torch.full(z.shape, -math.inf, device=z.device)
  s = torch.zeros(z.shape, device=z.device)
  sum_e = torch.zeros(z.shape, device=z.device)
  sum_sq = torch.zeros(z.shape, device=z.device)
  for lo in range(0, vocab_size, chunk):
    e = vals[lo:lo + chunk]
    diff = z[..., None] - e
    l = -0.5 * torch.square(diff * inv_stdev[..., None])
    m_new = torch.maximum(m, l.amax(dim=-1))
    rescale = torch.exp(m - m_new)
    w = torch.exp(l - m_new[..., None])
    s = s * rescale + w.sum(-1)
    sum_e = sum_e * rescale + (w * e).sum(-1)
    sum_sq = sum_sq * rescale + (w * torch.square(diff)).sum(-1)
    m = m_new
  ct = ct.float().reshape((-1,) + (1,) * (z.dim() - 1))
  dz = ct * inv_var * (e_x - sum_e / s)
  dg0 = ct * 0.5 * inv_var * (torch.square(z - e_x) - sum_sq / s)
  return dz, dg0


# Pixels one CUDA block reduces; an example spans ceil(n / this) blocks.
_PIXELS_PER_BLOCK = 1024


def _flat(z, *tensors):
  """(B, n) contiguous float32 copies of tensors broadcast to z."""
  b = z.shape[0]
  return [torch.as_tensor(t, dtype=torch.float32, device=z.device)
          .expand(z.shape).reshape(b, -1).contiguous() for t in tensors]


def decoder_logprob_fwd(x, z, g0, vocab_size: int = 256) -> torch.Tensor:
  """`decoder_logprob_plain` for CPU tensors; the K4 kernel otherwise."""
  if z.device.type == 'cpu':
    return decoder_logprob_plain(x, z, g0, vocab_size)
  if z.device.type != 'cuda':
    raise ValueError(f'decoder_logprob: unsupported device {z.device}')
  b = z.shape[0]
  n = z[0].numel()
  x2, z2, g2 = _flat(z, x, z, g0)
  n_blocks = -(-n // _PIXELS_PER_BLOCK)
  partial = torch.empty((b, n_blocks), dtype=torch.float32, device=z.device)
  out = torch.empty((b,), dtype=torch.float32, device=z.device)
  lib = _build.load_library()
  status = lib.mulan_decoder_logprob_fwd(
      x2.data_ptr(), z2.data_ptr(), g2.data_ptr(), partial.data_ptr(),
      out.data_ptr(), b, n, n_blocks, vocab_size,
      torch.cuda.current_stream(z.device).cuda_stream)
  _build.check(status, 'decoder_logprob')
  decoder_logprob.launches += 1
  return out


def decoder_logprob_bwd(x, z, g0, ct, vocab_size: int = 256):
  """`decoder_logprob_bwd_plain` for CPU tensors; the K5 kernel otherwise.
  g0 is per pixel, shaped like z."""
  if z.device.type == 'cpu':
    return decoder_logprob_bwd_plain(x, z, g0, ct, vocab_size)
  if z.device.type != 'cuda':
    raise ValueError(f'decoder_logprob_bwd: unsupported device {z.device}')
  if g0.shape != z.shape:
    raise ValueError(f'decoder_logprob_bwd: g0 {tuple(g0.shape)} must be '
                     f'per pixel, shaped like z {tuple(z.shape)}')
  b = z.shape[0]
  n = z[0].numel()
  x2, z2, g2 = _flat(z, x, z, g0)
  ct = ct.to(device=z.device, dtype=torch.float32).reshape(b).contiguous()
  dz, dg0 = torch.empty_like(z2), torch.empty_like(z2)
  status = _build.load_library().mulan_decoder_logprob_bwd(
      x2.data_ptr(), z2.data_ptr(), g2.data_ptr(), ct.data_ptr(),
      dz.data_ptr(), dg0.data_ptr(), b, n, vocab_size,
      torch.cuda.current_stream(z.device).cuda_stream)
  _build.check(status, 'decoder_logprob_bwd')
  decoder_logprob_bwd.launches += 1
  return dz.reshape(z.shape), dg0.reshape(z.shape)


class _DecoderLogprob(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, z, g0, vocab_size):
    ctx.save_for_backward(x, z, g0)
    ctx.vocab_size = vocab_size
    return decoder_logprob_fwd(x, z, g0, vocab_size)

  @staticmethod
  def backward(ctx, ct):
    x, z, g0 = ctx.saved_tensors
    dz, dg0 = decoder_logprob_bwd(x, z, g0, ct, ctx.vocab_size)
    return None, dz, dg0, None


def decoder_logprob(x, z, g0, vocab_size: int = 256) -> torch.Tensor:
  """Summed per-pixel log-likelihood, shape (B,): the plain versions for
  CPU tensors, the kernels for CUDA tensors, an error on any other device.

  x and z are shaped like the image batch (B, ...); g0 is per pixel or
  anything that broadcasts to z (a per-example or a single gamma_0). Under
  autograd g0 is expanded to z's shape before the kernel, so PyTorch sums
  the per-pixel dg0 back to g0's shape, as `_bwd` does in XLA
  (`mulan_tpu/ops/decoder_logprob.py:161-168`).
  """
  if z.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'decoder_logprob: unsupported device {z.device}')
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  if torch.is_grad_enabled() and (z.requires_grad or g0.requires_grad):
    return _DecoderLogprob.apply(x, z.float(), g0.expand(z.shape),
                                 vocab_size)
  return decoder_logprob_fwd(x, z, g0, vocab_size)


decoder_logprob.launches = 0
decoder_logprob_bwd.launches = 0
