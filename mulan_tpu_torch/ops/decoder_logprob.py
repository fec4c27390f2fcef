"""Decoder log-likelihood: CUDA kernel wrappers, their plain versions, and
the autograd function that joins them.

log p(x | z, g0) = sum over pixels of [l_x - logsumexp_v l_v], with
l_v = -0.5 ((z - e_v) exp(-g0/2))^2 and e_v = 2 (v + 1/2) / vocab - 1.

The kernels (`csrc/decoder_logprob.cu`) replace the Pallas TPU kernels of
`mulan_tpu/ops/decoder_logprob.py`: `_fwd_kernel` (K4, via `_run_fwd`) and
`_bwd_kernel` (K5, via `_bwd`), whose closed-form backward needs only the
softmax moments E_p[e_v] and E_p[(z - e_v)^2]. Both sum only over
`logsumexp_window`, the bins whose terms a float32 exp does not flush to 0,
from the largest term, at the bin nearest z. K5 reduces the gradient of a
broadcast g0 (one per example, or one in all) in the kernel, as `_bwd`
sums it back after its kernel. The plain forward streams the normalizer
over vocab chunks as `mulan_tpu/models/encdec.py:logprob` does; the plain
backward is K5's closed form and window in PyTorch. They run for CPU
tensors and are what the kernels are held against on the card.
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
  """(dz, dg0) of `decoder_logprob_plain` for the per-example cotangent ct
  (B,): dz = ct e^-g0 (e_x - E_p[e_v]) shaped like z, and dg0 = ct e^-g0
  ((z - e_x)^2 - E_p[(z - e_v)^2]) / 2 summed to g0's shape (g0 broadcasts
  to z), with p_v = softmax_v l_v.

  The moments are K5's: sums over `logsumexp_window` of w = exp(l_v -
  l_v*), from the largest term, at the bin v* nearest z: w, w e_v and w
  (z - e_v)^2 (`csrc/decoder_logprob.cu`). Float64 inputs are computed in
  float64, anything else in float32."""
  chunk = min(_CHUNK, vocab_size)
  dtype = torch.promote_types(z.dtype, torch.float32)
  z = z.to(dtype)
  g0 = torch.as_tensor(g0, dtype=dtype, device=z.device)
  g = torch.broadcast_to(g0, z.shape)
  inv_var = torch.exp(-g)
  first, last = logsumexp_window(z, g, vocab_size)
  v_star = torch.clamp(torch.round((z + 1) * (vocab_size / 2) - 0.5), 0,
                       vocab_size - 1)
  d_star_sq = torch.square(z - encode(v_star, vocab_size).to(dtype))
  e_x = encode(x, vocab_size).to(dtype)
  s, sum_e, sum_sq = (torch.zeros(z.shape, dtype=dtype, device=z.device)
                      for _ in range(3))
  for lo in range(0, vocab_size, chunk):
    v = torch.arange(lo, lo + chunk, dtype=dtype, device=z.device)
    e = encode(v, vocab_size).to(dtype)
    d_sq = torch.square(z[..., None] - e)
    inside = (v >= first[..., None]) & (v <= last[..., None])
    w = torch.where(inside, torch.exp(-0.5 * inv_var[..., None] * (
        d_sq - d_star_sq[..., None])), 0.0)
    s = s + w.sum(-1)
    sum_e = sum_e + (w * e).sum(-1)
    sum_sq = sum_sq + (w * d_sq).sum(-1)
  scale = ct.to(dtype).reshape((-1,) + (1,) * (z.dim() - 1)) * inv_var
  dz = scale * (e_x - sum_e / s)
  dg0 = 0.5 * scale * (torch.square(z - e_x) - sum_sq / s)
  return dz, dg0.sum_to_size(g0.shape)


# Pixels one CUDA block of K4 reduces; an example spans ceil(n / this).
_PIXELS_PER_BLOCK = 1024
# K5 runs one pixel a thread, 256 a block.
_BWD_PIXELS_PER_BLOCK = 256


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


# How K5 reads g0: per pixel, per example, or one number.
PER_PIXEL, PER_EXAMPLE, ONE = 0, 1, 2


def g0_mode(g0: torch.Tensor, z: torch.Tensor) -> int:
  """K5's `g_mode` for g0 beside z: ONE for a single value, PER_EXAMPLE
  for (B, 1, ..., 1), PER_PIXEL otherwise (g0 expanded to z's shape)."""
  if g0.numel() == 1:
    return ONE
  if (g0.dim() == z.dim() and g0.shape[0] == z.shape[0]
      and g0.numel() == z.shape[0]):
    return PER_EXAMPLE
  return PER_PIXEL


def decoder_logprob_bwd(x, z, g0, ct, vocab_size: int = 256, *,
                        need_dz: bool = True, need_dg0: bool = True):
  """(dz, dg0) of `decoder_logprob_bwd_plain`: for CPU tensors that
  function; for CUDA tensors the K5 kernel, which writes dz only if
  `need_dz` and dg0 only if `need_dg0` (None in their place otherwise) and
  reduces a broadcast g0's gradient itself. dg0 has g0's shape."""
  if z.device.type == 'cpu':
    dz, dg0 = decoder_logprob_bwd_plain(x, z, g0, ct, vocab_size)
    return dz if need_dz else None, dg0 if need_dg0 else None
  if z.device.type != 'cuda':
    raise ValueError(f'decoder_logprob_bwd: unsupported device {z.device}')
  b = z.shape[0]
  n = z[0].numel()
  x2, z2 = _flat(z, x, z)
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  mode = g0_mode(g0, z)
  g2 = (_flat(z, g0)[0] if mode == PER_PIXEL
        else g0.reshape(-1).contiguous())
  ct = ct.to(device=z.device, dtype=torch.float32).reshape(b).contiguous()
  n_blocks = -(-n // _BWD_PIXELS_PER_BLOCK)
  dz = torch.empty_like(z2) if need_dz else None
  dg0 = partial = None
  if need_dg0:
    dg0 = torch.empty_like(z2 if mode == PER_PIXEL else g2)
    if mode != PER_PIXEL:
      partial = torch.empty((b, n_blocks), dtype=torch.float32,
                            device=z.device)
  status = _build.load_library().mulan_decoder_logprob_bwd(
      x2.data_ptr(), z2.data_ptr(), g2.data_ptr(), ct.data_ptr(),
      *(None if t is None else t.data_ptr() for t in (dz, dg0, partial)),
      b, n, n_blocks, mode, vocab_size,
      torch.cuda.current_stream(z.device).cuda_stream)
  _build.check(status, 'decoder_logprob_bwd')
  decoder_logprob_bwd.launches += 1
  if dz is not None:
    dz = dz.reshape(z.shape)
  if dg0 is not None:
    dg0 = (dg0.reshape(z.shape).sum_to_size(g0.shape) if mode == PER_PIXEL
           else dg0.reshape(g0.shape))
  return dz, dg0


class _DecoderLogprob(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, z, g0, vocab_size):
    ctx.save_for_backward(x, z, g0)
    ctx.vocab_size = vocab_size
    return decoder_logprob_fwd(x, z, g0, vocab_size)

  @staticmethod
  def backward(ctx, ct):
    x, z, g0 = ctx.saved_tensors
    dz, dg0 = decoder_logprob_bwd(x, z, g0, ct, ctx.vocab_size,
                                  need_dz=ctx.needs_input_grad[1],
                                  need_dg0=ctx.needs_input_grad[2])
    return None, dz, dg0, None


def decoder_logprob(x, z, g0, vocab_size: int = 256) -> torch.Tensor:
  """Summed per-pixel log-likelihood, shape (B,): the plain versions for
  CPU tensors, the kernels for CUDA tensors, an error on any other device.

  x and z are shaped like the image batch (B, ...); g0 is per pixel or
  anything that broadcasts to z (a per-example or a single gamma_0). Under
  autograd the backward (K5) reduces dg0 to g0's shape, as `_bwd` does
  after its kernel (`mulan_tpu/ops/decoder_logprob.py:161-168`), and
  computes only the gradients autograd asks for.
  """
  if z.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'decoder_logprob: unsupported device {z.device}')
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  if torch.is_grad_enabled() and (z.requires_grad or g0.requires_grad):
    return _DecoderLogprob.apply(x, z.float(), g0, vocab_size)
  return decoder_logprob_fwd(x, z, g0, vocab_size)


decoder_logprob.launches = 0
decoder_logprob_bwd.launches = 0
