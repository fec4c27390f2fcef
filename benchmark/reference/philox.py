"""Dropout keep masks from Philox4x32-10, in plain PyTorch.

A frozen copy of the masks' definition, so that the reference draws the
same masks as the program under test without importing it. The mask of a
dropout site is keyed by (seed, site). Global element i of the site's mask
takes 16-bit draw i % 8 of counter i // 8: the four 32-bit output words of
Philox4x32-10 (counter = (i // 8 low word, high word, 0, 0), key = (seed,
site)) give two draws each, low half first. The element is kept iff its
draw >= min(round(rate * 65536), 65535), and a kept element has the value
1 / (1 - threshold / 65536), rounded to float32.

The arithmetic runs on int64 tensors, every 32-bit product split into
16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold16(rate: float) -> int:
  return min(int(round(rate * 65536.0)), 65535)


def keep_value(rate: float) -> float:
  """The value of a kept element, rounded to float32."""
  scale = 1.0 / (1.0 - threshold16(rate) / 65536.0)
  return float(torch.tensor(scale, dtype=torch.float32))


def _mulhilo(m: int, x: torch.Tensor):
  m_hi, m_lo = m >> 16, m & 0xFFFF
  lo_part = x * m_lo
  hi_part = x * m_hi
  mid = lo_part + ((hi_part & 0xFFFF) << 16)
  lo = mid & _MASK32
  hi = ((hi_part >> 16) + (mid >> 32)) & _MASK32
  return hi, lo


def philox4x32_10(counter, key):
  """Philox4x32-10 on int64 tensors holding 32-bit values."""
  c0, c1, c2, c3 = counter
  k0, k1 = key[0] & _MASK32, key[1] & _MASK32
  for r in range(10):
    if r:
      k0 = (k0 + PHILOX_W[0]) & _MASK32
      k1 = (k1 + PHILOX_W[1]) & _MASK32
    hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
    hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
    c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
  return c0, c1, c2, c3


def keep_mask(seed: int, site: int, shape, rate: float, device,
              first_index: int = 0) -> torch.Tensor:
  """Float32 mask of `shape`: elements [first_index, first_index + numel)
  of the site's global mask, values in {0, keep_value(rate)}."""
  n = math.prod(int(d) for d in shape)
  lo = first_index // 8
  hi = (first_index + n + 7) // 8
  ctr = torch.arange(lo, hi, dtype=torch.int64, device=device)
  zero = torch.zeros_like(ctr)
  words = torch.stack(philox4x32_10((ctr & _MASK32, ctr >> 32, zero, zero),
                                    (seed, site)), dim=-1)
  draws = torch.stack([words & 0xFFFF, words >> 16], -1).reshape(-1)
  skip = first_index - 8 * lo
  keep = draws[skip:skip + n] >= threshold16(rate)
  return torch.where(keep, keep_value(rate), 0.0).reshape(shape)
