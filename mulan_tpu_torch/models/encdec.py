"""Data encoder/decoder: uint8 images <-> [-1, 1], exact categorical decoder.

Counterpart of `mulan_tpu/models/encdec.py`. The streamed `logprob` (the
reconstruction term) lives beside its CUDA kernel in
`ops/decoder_logprob.py`; `EncDec.logprob` picks between the two by
`config.use_kernels`.
"""

from __future__ import annotations

import torch

from mulan_tpu_torch.models.config import ModelConfig
from mulan_tpu_torch.ops.decoder_logprob import (
    decoder_logprob, decoder_logprob_plain as logprob, encode)

__all__ = ['EncDec', 'decode_logits', 'encode', 'logprob']


def decode_logits(z: torch.Tensor, g_0: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
  """Unnormalized per-pixel categorical logits, shape (..., vocab)."""
  vals = encode(torch.arange(vocab_size, device=z.device), vocab_size)
  inv_stdev = torch.exp(-0.5 * torch.as_tensor(g_0, dtype=torch.float32,
                                               device=z.device))
  diff = (z[..., None] - vals) * inv_stdev[..., None]
  return -0.5 * torch.square(diff)


class EncDec:
  """Stateless wrapper bound to a ModelConfig."""

  def __init__(self, config: ModelConfig):
    self.config = config

  def encode(self, x):
    return encode(x, self.config.vocab_size)

  def decode_logits(self, z, g_0):
    return decode_logits(z, g_0, self.config.vocab_size)

  def logprob(self, x, z, g_0):
    fn = decoder_logprob if self.config.use_kernels else logprob
    return fn(x, z, g_0, self.config.vocab_size)
