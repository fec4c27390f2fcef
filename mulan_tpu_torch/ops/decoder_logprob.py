"""Decoder log-likelihood forward: CUDA kernel wrapper and its plain version.

log p(x | z, g0) = sum over pixels of [l_x - logsumexp_v l_v], with
l_v = -0.5 ((z - e_v) exp(-g0/2))^2 and e_v = 2 (v + 1/2) / vocab - 1.

The kernel (`csrc/decoder_logprob.cu`) replaces the Pallas TPU kernel
`mulan_tpu/ops/decoder_logprob.py:_fwd_kernel` (via `_run_fwd`). The plain
version streams the normalizer over vocab chunks as
`mulan_tpu/models/encdec.py:logprob` does; it runs for CPU tensors and is the
reference the kernel is held against on the card.
"""

from __future__ import annotations

import math

import torch

from mulan_tpu_torch.ops import _build


def encode(x: torch.Tensor, vocab_size: int) -> torch.Tensor:
  """Map discrete values {0..vocab-1} to centred bins in (-1, 1)."""
  x = torch.round(x.float())
  return 2.0 * ((x + 0.5) / vocab_size) - 1.0


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


# Pixels one CUDA block reduces; an example spans ceil(n / this) blocks.
_PIXELS_PER_BLOCK = 1024


def decoder_logprob(x, z, g0, vocab_size: int = 256) -> torch.Tensor:
  """`decoder_logprob_plain` for CPU tensors; the CUDA kernel otherwise.

  x and z are shaped like the image batch (B, ...); g0 is per pixel or
  anything that broadcasts to z (a per-example or a single gamma_0).
  """
  if z.device.type == 'cpu':
    return decoder_logprob_plain(x, z, g0, vocab_size)
  if z.device.type != 'cuda':
    raise ValueError(f'decoder_logprob: unsupported device {z.device}')
  b = z.shape[0]
  n = z[0].numel()
  g0 = torch.as_tensor(g0, dtype=torch.float32, device=z.device)
  x2, z2, g2 = (t.to(device=z.device, dtype=torch.float32).expand(z.shape)
                .reshape(b, n).contiguous() for t in (x, z, g0))
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


decoder_logprob.launches = 0
