"""Inverted dropout with a counter-based mask: CUDA kernel wrappers, their
plain versions, and the autograd function that regenerates the mask.

The kernel (`csrc/dropout.cu`) replaces the Pallas TPU kernel
`mulan_tpu/ops/dropout.py:_mask_kernel`, which JAX launches two ways:
- K6 (`dropout_mask`, for `_hw_mask` / `hw_dropout`): one site's mask. As
  there, it writes only the pre-scaled keep mask, values in {0, scale}; the
  x * mask product stays a PyTorch op, and the backward regenerates the mask
  from (seed, site, rate) instead of saving it (`hw_dropout`'s vjp,
  `mulan_tpu/ops/dropout.py:161-177`).
- K7 (`dropout_mask_batch`, for `hw_mask_batch`, `:120-158`): the masks of
  n consecutive sites in one launch, which the caller applies as
  `h * masks[i]` and keeps for the backward. Slot i is bit for bit the K6
  mask of site first_site + i, so with one seed the batched path changes
  which kernel runs, how often, and what memory the step holds, and nothing
  else; the TPU kernel promises only K6's statistics.

The TPU's hardware bits have no counterpart here: both versions draw from
Philox4x32-10, keyed by (seed, site), with the counter index // 8. Each of
the four 32-bit output words gives two 16-bit draws, low half first, and an
element is kept iff its draw >= threshold16 = min(round(rate * 65536),
65535); the realized rate is `effective_rate`, as on the TPU. The plain
version runs the same Philox on int64 tensors (every 32-bit product split in
16-bit halves, so no step overflows), so kernel and plain agree bit for bit
on the card, and a model's masks do not depend on `use_kernels`.

Both take `first_index`: the mask is then elements [first_index,
first_index + n) of the site's global mask, the counter formed from the
global index. A data-parallel rank holding rows [r b, (r + 1) b) of the
global batch passes r b times a row's elements, so every rank drops its
own rows of the mask one process would draw (`mulan_tpu/ops/dropout.py`
computes the mask whole at the global shape and the partitioner slices
it). With `row_stride` too, the mask's rows lie that many elements apart
in the global mask: a tensor-parallel rank's activation (B, C / tp, H, W)
holds channels [r C / tp, (r + 1) C / tp) of the global (B, C, H, W), B
runs of (C / tp) H W elements C H W apart, from first_index = (first row)
C H W + r (C / tp) H W (`channel_window`).
"""

from __future__ import annotations

import functools
import math

import torch

from mulan_tpu_torch.ops import _build
from mulan_tpu_torch.utils import tracing

_DTYPES = (torch.float32, torch.bfloat16)
_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold16(rate: float) -> int:
  return min(int(round(rate * 65536.0)), 65535)


def effective_rate(rate: float) -> float:
  """The realized drop probability, `rate` quantized to 16 bits
  (`mulan_tpu/ops/dropout.py:effective_rate`)."""
  return threshold16(rate) / 65536.0


def keep_scale(rate: float) -> float:
  """The value of a kept element, 1 / (1 - effective_rate), so E[mask] = 1."""
  return 1.0 / (1.0 - effective_rate(rate))


@functools.lru_cache(maxsize=64)
def kernel_constants(rate: float) -> tuple[int, float]:
  """(threshold16, keep scale rounded to float32) of `rate`, the kernels'
  arguments: computed once per rate (a model uses one or two), not on
  every launch."""
  return threshold16(rate), float(torch.tensor(keep_scale(rate),
                                               dtype=torch.float32))


def _mulhilo(m: int, x: torch.Tensor):
  """(hi, lo) 32-bit halves of m * x for a 32-bit constant m and int64 x
  holding 32-bit values; each partial product stays below 2^49."""
  m_hi, m_lo = m >> 16, m & 0xFFFF
  lo_part = x * m_lo                          # < 2^48
  hi_part = x * m_hi                          # < 2^48
  mid = lo_part + ((hi_part & 0xFFFF) << 16)  # < 2^49
  lo = mid & _MASK32
  hi = ((hi_part >> 16) + (mid >> 32)) & _MASK32
  return hi, lo


def philox4x32_10(counter, key):
  """Philox4x32-10 on int64 tensors: counter is 4 tensors of 32-bit values
  (broadcastable), key 2 Python ints; returns 4 int64 tensors."""
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


def _check(shape, rate, dtype, first_index=0, row_stride=None):
  if not 0 <= first_index < 2 ** 63:
    raise ValueError(f'dropout mask first_index {first_index} must be in '
                     '[0, 2^63)')
  if not 0.0 <= rate < 1.0:
    raise ValueError(f'dropout rate {rate} must be in [0, 1)')
  if dtype not in _DTYPES:
    raise ValueError(f'dropout mask dtype {dtype} must be float32 or '
                     f'bfloat16')
  if row_stride is not None:
    run = math.prod(shape[1:])
    span = (shape[0] - 1) * row_stride + run
    if row_stride < run or first_index + span > 2 ** 63:
      raise ValueError(f'dropout mask rows of {run} elements cannot lie '
                       f'{row_stride} apart from {first_index}')


def _draws(seed: int, site: int, lo: int, hi: int, device):
  """The 16-bit draws (int64) of global elements [8 lo, 8 hi) of the
  site's mask: counters lo .. hi - 1, eight draws each."""
  ctr = torch.arange(lo, hi, dtype=torch.int64, device=device)
  zero = torch.zeros_like(ctr)
  words = philox4x32_10((ctr & _MASK32, ctr >> 32, zero, zero),
                        (seed, site))
  words = torch.stack(words, dim=-1)                     # (ctr, 4)
  return torch.stack([words & 0xFFFF, words >> 16], -1).reshape(-1)


def dropout_mask_plain(seed: int, site: int, shape, rate: float, dtype,
                       device=None, first_index: int = 0,
                       row_stride=None) -> torch.Tensor:
  """The keep mask of `shape` for (seed, site), values in {0, scale}:
  elements [first_index, first_index + numel) of the site's global mask
  (a data-parallel rank's rows of the global batch), or with `row_stride`
  the rows of `shape` taken `row_stride` elements apart from first_index
  on (a channel window)."""
  _check(shape, rate, dtype, first_index, row_stride)
  device = torch.device('cpu' if device is None else device)
  n = math.prod(int(dim) for dim in shape)
  rows = int(shape[0]) if len(shape) else 1
  run = n // rows if rows else 0
  span = n if row_stride is None else (rows - 1) * row_stride + run
  lo = first_index // 8
  draws = _draws(seed, site, lo, (first_index + span + 7) // 8, device)
  skip = first_index - 8 * lo
  if row_stride is None:
    draws = draws[skip:skip + n]
  else:
    at = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
          * row_stride + torch.arange(run, dtype=torch.int64,
                                      device=device)[None, :] + skip)
    draws = draws[at.reshape(-1)]
  keep = draws >= threshold16(rate)
  scale = torch.tensor(keep_scale(rate), dtype=torch.float32).to(dtype)
  zeros = torch.zeros((), dtype=dtype, device=device)
  return torch.where(keep, scale.to(device), zeros).reshape(shape)


def _window(shape, row_stride):
  """The kernels' (run, row_stride): (0, 0) for a contiguous mask."""
  if row_stride is None:
    return 0, 0
  return math.prod(shape[1:]), row_stride


def dropout_mask(seed: int, site: int, shape, rate: float, dtype,
                 device=None, first_index: int = 0,
                 row_stride=None) -> torch.Tensor:
  """`dropout_mask_plain` on the CPU; the K6 kernel on a CUDA device."""
  device = torch.device('cpu' if device is None else device)
  if device.type == 'cpu':
    return dropout_mask_plain(seed, site, shape, rate, dtype, device,
                              first_index, row_stride)
  if device.type != 'cuda':
    raise ValueError(f'dropout_mask: unsupported device {device}')
  _check(shape, rate, dtype, first_index, row_stride)
  out = torch.empty(shape, dtype=dtype, device=device)
  status = _build.load_library().mulan_dropout_mask(
      out.data_ptr(), out.numel(), seed & _MASK32, site & _MASK32,
      *kernel_constants(rate), first_index, *_window(shape, row_stride),
      int(dtype == torch.bfloat16),
      torch.cuda.current_stream(device).cuda_stream)
  _build.check(status, 'dropout_mask')
  tracing.count('dropout_mask', elements=out.numel(), dtype=dtype, masks=1)
  return out


def dropout_mask_batch_plain(seed: int, first_site: int, n_masks: int, shape,
                             rate: float, dtype, device=None,
                             first_index: int = 0,
                             row_stride=None) -> torch.Tensor:
  """(n_masks, *shape): slot i is `dropout_mask_plain(seed, first_site + i,
  shape, ..., first_index, row_stride)`: every slot at the same offset
  and window in its site."""
  return torch.stack([dropout_mask_plain(seed, first_site + i, shape, rate,
                                         dtype, device, first_index,
                                         row_stride)
                      for i in range(n_masks)])


def dropout_mask_batch(seed: int, first_site: int, n_masks: int, shape,
                       rate: float, dtype, device=None,
                       first_index: int = 0,
                       row_stride=None) -> torch.Tensor:
  """`dropout_mask_batch_plain` on the CPU; the K7 kernel, one launch for
  all slots, on a CUDA device."""
  device = torch.device('cpu' if device is None else device)
  if device.type == 'cpu':
    return dropout_mask_batch_plain(seed, first_site, n_masks, shape, rate,
                                    dtype, device, first_index, row_stride)
  if device.type != 'cuda':
    raise ValueError(f'dropout_mask_batch: unsupported device {device}')
  _check(shape, rate, dtype, first_index, row_stride)
  if not 1 <= n_masks <= 65535:
    raise ValueError(f'dropout_mask_batch: {n_masks} masks, not 1 to 65535')
  out = torch.empty((n_masks, *shape), dtype=dtype, device=device)
  status = _build.load_library().mulan_dropout_mask_batch(
      out.data_ptr(), out[0].numel(), n_masks, seed & _MASK32,
      first_site & _MASK32, *kernel_constants(rate), first_index,
      *_window(shape, row_stride), int(dtype == torch.bfloat16),
      torch.cuda.current_stream(device).cuda_stream)
  _build.check(status, 'dropout_mask_batch')
  tracing.count('dropout_mask_batch', elements=out[0].numel(), dtype=dtype,
                masks=n_masks)
  return out


def dropout_masks(seed: int, first_site: int, n_masks: int, shape,
                  rate: float, dtype, device, use_kernel: bool,
                  first_row: int = 0, channels=None):
  """The masks of sites first_site .. first_site + n_masks - 1 at once: from
  K7 (`dropout_mask_batch`) with `use_kernel`, else from
  `dropout_mask_batch_plain`; both give the same bits. `shape` holds this
  rank's rows of the global batch, which start at row `first_row`, and
  with `channels` its channel window (`channel_window`)."""
  # Looked up at call time, so that tests can substitute the plain masks.
  fn = dropout_mask_batch if use_kernel else dropout_mask_batch_plain
  return fn(seed, first_site, n_masks, shape, rate, dtype, device,
            **_offset(first_row, shape, channels))


def channel_window(first_row: int, shape, channels):
  """(first_index, row_stride) of an NC... mask `shape` whose rows start at
  global row `first_row` and whose shape[1] channels start at channel
  `channels[0]` of the site's `channels[1]`."""
  first_channel, total = channels
  if not 0 <= first_channel <= total - shape[1]:
    raise ValueError(f'channels [{first_channel}, '
                     f'{first_channel + shape[1]}) of {total}')
  per_channel = math.prod(shape[2:])
  row_stride = total * per_channel
  return first_row * row_stride + first_channel * per_channel, row_stride


def _offset(first_row, shape, channels=None):
  """The `first_index` (and, for a channel window, `row_stride`) keywords
  of a mask whose rows start at `first_row`; none at row 0 without a
  window, so that one process calls the mask functions as it always has
  (and stand-ins of that signature keep working)."""
  if channels is not None:
    first_index, row_stride = channel_window(first_row, shape, channels)
    return {'first_index': first_index, 'row_stride': row_stride}
  return {'first_index': first_row * math.prod(shape[1:])} if first_row else {}


def _make_mask(seed, site, like, rate, use_kernel, first_row=0,
               channels=None):
  # Looked up at call time, so that tests can substitute the plain mask.
  fn = dropout_mask if use_kernel else dropout_mask_plain
  return fn(seed, site, like.shape, rate, like.dtype, like.device,
            **_offset(first_row, like.shape, channels))


class _Dropout(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, seed, site, rate, use_kernel, first_row, channels):
    ctx.args = (seed, site, rate, use_kernel, first_row, channels)
    return x * _make_mask(seed, site, x, rate, use_kernel, first_row,
                          channels)

  @staticmethod
  def backward(ctx, ct):
    seed, site, *rest = ctx.args
    return (ct * _make_mask(seed, site, ct, *rest),
            None, None, None, None, None, None)


def dropout(x: torch.Tensor, seed: int, site: int, rate: float,
            use_kernel: bool, first_row: int = 0,
            channels=None) -> torch.Tensor:
  """x * mask(seed, site); the backward regenerates the same mask. The
  mask comes from the K6 kernel (`dropout_mask`) with `use_kernel`, else
  from `dropout_mask_plain`; both give the same bits. x holds this rank's
  rows of the global batch, from row `first_row` on, and with `channels`
  = (first channel, the site's channels) a tensor-parallel rank's channel
  window: its mask is that window of the global site's mask."""
  return _Dropout.apply(x, seed, site, rate, use_kernel, first_row, channels)
