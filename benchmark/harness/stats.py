"""The arithmetic that turns what a run recorded into its metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(units: float, seconds: float) -> float:
  """Units of work a second over the whole span."""
  if seconds <= 0:
    raise ValueError(f'a span of {seconds} s')
  return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
  """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
  with at least q% of the values at or below it."""
  if not values:
    raise ValueError('no values')
  ordered = sorted(values)
  rank = max(1, math.ceil(q / 100.0 * len(ordered)))
  return ordered[rank - 1]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
  """The length of the union of [start, end) intervals."""
  total, cur_lo, cur_hi = 0.0, None, None
  for lo, hi in sorted(intervals):
    if cur_hi is None or lo > cur_hi:
      if cur_hi is not None:
        total += cur_hi - cur_lo
      cur_lo, cur_hi = lo, hi
    else:
      cur_hi = max(cur_hi, hi)
  if cur_hi is not None:
    total += cur_hi - cur_lo
  return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
  """The stretches of [lo, hi) that no interval covers, in order."""
  out, at = [], lo
  for a, b in sorted(intervals):
    if a > at:
      out.append((at, min(a, hi)))
    at = max(at, b)
    if at >= hi:
      break
  if at < hi:
    out.append((at, hi))
  return [(a, b) for a, b in out if b > a]
