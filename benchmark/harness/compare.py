"""The numbers the correctness check compares.

Norms are compared leaf by leaf, by the worst leaf: the gap between the
program's norm of a leaf and the reference's, over the reference's norm of
that leaf or of the median leaf, whichever is larger (some gradients are
all but zero).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Tuple

import torch

# Leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: they are left out of the
# parameters' change.
NEGLIGIBLE_GRADIENT = 1e-3


@torch.no_grad()
def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
  """{name: 2-norm}, read from the device once."""
  names = list(tensors)
  values = torch.stack(torch._foreach_norm(
      [tensors[n].float() for n in names])).tolist()
  return dict(zip(names, values))


@torch.no_grad()
def change_norms(after: Dict[str, torch.Tensor],
                 before: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return norms({k: after[k].detach().float() - before[k].float()
                for k in after})


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               leave_out: Iterable[str] = ()) -> Tuple[float, str]:
  """(the largest relative gap over the leaves, its leaf)."""
  if set(program) != set(reference):
    missing = sorted(set(reference) ^ set(program))[:4]
    raise ValueError(f'the leaves differ: {missing}')
  skip = set(leave_out)
  kept = [k for k in reference if k not in skip]
  median = statistics.median(reference[k] for k in kept)
  worst, leaf = 0.0, ''
  for k in kept:
    gap = abs(program[k] - reference[k]) / max(reference[k], median)
    if gap > worst or not leaf:
      worst, leaf = gap, k
  return worst, leaf


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leave_out: Iterable[str] = ()):
  """[(gap, leaf)] from the largest, as `worst_leaf` measures them."""
  skip = set(leave_out)
  kept = [k for k in reference if k not in skip]
  median = statistics.median(reference[k] for k in kept)
  return sorted(((abs(program[k] - reference[k]) / max(reference[k], median),
                  k) for k in kept), reverse=True)


def negligible(gradient_norms: Dict[str, float]):
  """The leaves whose gradient is under NEGLIGIBLE_GRADIENT of the median
  leaf's."""
  median = statistics.median(gradient_norms.values())
  return sorted(k for k, v in gradient_norms.items()
                if v < NEGLIGIBLE_GRADIENT * median)


def relative(program: float, reference: float) -> float:
  return abs(program - reference) / abs(reference)


def worst_relative(program, reference) -> float:
  return max(relative(p, r) for p, r in zip(program, reference, strict=True))
