"""The readers of K8's roofline shares, `k8_roofline.train` and
`k8_roofline.eval`: the least time of the GroupNorm+swish work that the
program counted in the traced calls (its `gn_swish` and `gn_swish_bwd`
launches, each recorded with its elements and type; `harness/roofline.py`
gives their bytes) over the device time of K8's trace categories there,
in %. Each returns None where the program counts no such launch or the
trace holds no time in those categories.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness import program
from benchmark.harness import roofline

FWD_CATEGORY = 'K8 GroupNorm+swish'
BWD_CATEGORY = 'K8 GroupNorm+swish backward'
_BYTES = {'gn_swish': roofline.gn_swish_bytes,
          'gn_swish_bwd': roofline.gn_swish_bwd_bytes}


def share(record, kernels, categories, recorder=None) -> Optional[float]:
  """The counted work of `kernels` (of `_BYTES`) in the traced calls, as
  the least time it needs, over the device time of `categories` there."""
  t = record.get('trace')
  units = program.traced_units(record, recorder)
  spent = sum(t['by_category_s'].get(c, 0.0) for c in categories) if t else 0
  if units is None or not spent:
    return None
  bound = 0.0
  for u in units:
    for (kernel, _, work), n in u['counts'].items():
      if kernel in kernels:
        work = dict(work)
        dtype = str(work['dtype']).replace('torch.', '')
        bound += n * roofline.bound_s(
            0.0, _BYTES[kernel](work['elements'], dtype), dtype)
  return 100.0 * bound / spent if bound else None


def train(record) -> Optional[float]:
  if record['entry'] != 'train':
    return None
  return share(record, ('gn_swish', 'gn_swish_bwd'),
               (FWD_CATEGORY, BWD_CATEGORY))


def dense_eval(record) -> Optional[float]:
  if record['entry'] != 'dense_eval':
    return None
  return share(record, ('gn_swish',), (FWD_CATEGORY,))
