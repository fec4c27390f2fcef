"""The check that nothing a run loads is JAX or the JAX package.

Names are compared by their top-level part (before the first dot) as a
whole: `mulan_tpu_torch` is the program, `mulan_tpu` the JAX package it
was ported from.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'mulan_tpu'})


def forbidden(names: Iterable[str]) -> List[str]:
  """The module names among `names` whose top-level name is forbidden."""
  return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
  return forbidden(list(sys.modules))
